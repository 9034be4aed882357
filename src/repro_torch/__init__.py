"""PyTorch/CUDA port of the Hydra data-series search system.

A package of its own beside the JAX reference (``src/repro``): the same
modules under the same names, on torch tensors, with the reference's
Pallas TPU kernels rewritten as CUDA C++ for Hopper (``kernels/csrc``).
Entry points run on the card unless the caller passes ``device="cpu"``.
"""
