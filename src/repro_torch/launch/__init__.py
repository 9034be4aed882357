"""Launch entry points: ``serve`` (batched decode with retrieval-augmented
answers over the engine) and ``train`` (``fit``: the training loop with
checkpoints and restarts). The port's copy of the serving and training
halves of ``src/repro/launch``, on one card."""
