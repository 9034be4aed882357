"""Training: the optimizer, error-feedback compression, the train step,
checkpoints and the fault-tolerant supervisor. The port's copy of
``src/repro/train`` on one card (the collective ``compressed_psum``
waits for the multi-GPU slice)."""

from . import checkpoint, compress, fault, optimizer, train_step

__all__ = ["checkpoint", "compress", "fault", "optimizer", "train_step"]
