"""Launch entry points: ``serve`` (batched decode with retrieval-augmented
answers over the engine). The port's copy of the serving half of
``src/repro/launch``."""
