"""Where the port runs: the card unless the caller asks for the CPU."""

from __future__ import annotations

import dataclasses

import torch

DEFAULT = "cuda"


def resolve(device) -> torch.device:
    """The torch.device for an entry point's ``device`` argument.

    Raises when a CUDA device is asked for (the default) and none is
    present: an entry point never moves to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def matching(where: torch.device, device) -> torch.device:
    """Resolve ``device`` for a call on state that lives on ``where``
    (an index's tensors) and check that the two agree."""
    dev = resolve(device)
    if where.type != dev.type:
        raise ValueError(f"the index lives on {where}, the call was asked "
                         f"to run on {dev}")
    return dev


def to_device(state, device):
    """A copy of ``state`` (an index, a frozen dataclass) with every
    tensor field on ``device``; the other fields are shared."""
    dev = resolve(device)
    return dataclasses.replace(state, **{
        f.name: getattr(state, f.name).to(dev)
        for f in dataclasses.fields(state)
        if isinstance(getattr(state, f.name), torch.Tensor)})
