"""The paper's synthetic collections and query workloads (numpy, host),
and the synthetic token pipeline for LM training (``tokens``,
``pipeline``)."""
