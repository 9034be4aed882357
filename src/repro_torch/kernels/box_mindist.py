"""K1 ``box_mindist``: the weighted box lower bound of the filter stage.

Replaces ``src/repro/kernels/box_mindist.py`` (``box_mindist_pallas`` /
``_box_kernel``) with ``csrc/box_mindist.cu``. On the card the pass is
bound by bytes: the [B, L] f32 output, then the [L, D] box corners. A
block stages a tile of boxes in shared memory with coalesced reads,
each thread holds one box in registers (up to 32 dims; a wider box in
chunks of 32, the running sums kept in the output between chunks) and
writes its column of lanes; the sum over D runs left to right like
:func:`ref.ref_box_mindist`, so the two agree bit for bit.
"""

from __future__ import annotations

import torch

from . import ref


def box_mindist(q: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                weights: torch.Tensor) -> torch.Tensor:
    """Squared weighted box distances [B, L] f32 for summaries q [B, D],
    boxes lo/hi [L, D] and weights [D]. A CPU tensor takes the plain
    version; CUDA tensors (f32, contiguous, any D) launch the kernel."""
    if q.device.type == "cpu":
        return ref.ref_box_mindist(q, lo, hi, weights)
    from . import build

    for t, name in ((q, "q"), (lo, "lo"), (hi, "hi")):
        build.require(t, (torch.float32,), f"box_mindist {name}", 2)
    build.require(weights, (torch.float32,), "box_mindist weights", 1)
    b, d = q.shape
    n_boxes = lo.shape[0]
    if lo.shape[1] != d or hi.shape != lo.shape or weights.shape[0] != d:
        raise ValueError(f"box_mindist shapes disagree: q {q.shape}, "
                         f"lo {lo.shape}, hi {hi.shape}, w {weights.shape}")
    if d < 1:
        raise ValueError(f"box_mindist needs summary dims, got {q.shape}")
    out = torch.empty((b, n_boxes), dtype=torch.float32, device=q.device)
    lib = build.library("box_mindist")
    with torch.cuda.device(q.device):
        build.check(lib.box_mindist_f32(
            q.data_ptr(), lo.data_ptr(), hi.data_ptr(), weights.data_ptr(),
            out.data_ptr(), b, n_boxes, d, build.stream(q)), "box_mindist")
    build.count_launch(box_mindist)
    return out


box_mindist.launches = 0
