"""The model substrate: parameter specs, layers, attention, the decoder
stack and the model facade (the port's copy of ``src/repro/models``).

Submodules are not imported eagerly: ``configs.base`` imports ``moe`` and
``ssm`` for their config NamedTuples, while the model modules import
``configs.base``.
"""
