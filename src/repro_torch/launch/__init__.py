"""Launch entry points: ``serve`` (batched decode with retrieval-augmented
answers over the engine), ``train`` (``fit``: the training loop with
checkpoints and restarts), the dry run and roofline (``analytic``,
``roofline``, ``dryrun``, ``dryrun_search``), and ``mesh`` (the process
group and device meshes) with ``distributed_search`` (the sharded engine
across ranks). The port's copy of ``src/repro/launch``; training and the
dry run run on one card."""
