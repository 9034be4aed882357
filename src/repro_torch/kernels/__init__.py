"""Hand-written Hopper kernels (``csrc/*.cu``), their plain PyTorch
versions (``ref``) and the operations the search core calls (``ops``)."""
