"""K2 ``paa``: segment means, the iSAX summary.

Replaces ``src/repro/kernels/paa.py`` (``paa_pallas`` / ``_paa_kernel``)
with ``csrc/paa.cu``. On the card the pass is bound by bytes: each input
float is read once for one add. One thread sums one (row, segment)
stretch left to right and scales it by the same float32 reciprocal as
:func:`ref.ref_paa`, so the kernel and the plain version agree bit for
bit.
"""

from __future__ import annotations

import torch

from . import ref


def paa(x: torch.Tensor, n_segments: int) -> torch.Tensor:
    """Segment means [N, n] -> [N, l] f32. A CPU tensor takes the plain
    version; a CUDA tensor (f32, contiguous) launches the kernel."""
    if x.device.type == "cpu":
        return ref.ref_paa(x, n_segments)
    from . import build

    build.require(x, (torch.float32,), "paa x", 2)
    n_rows, n = x.shape
    inv = ref.inv_width(n, n_segments)
    out = torch.empty((n_rows, n_segments), dtype=torch.float32,
                      device=x.device)
    lib = build.library("paa")
    with torch.cuda.device(x.device):
        build.check(lib.paa_f32(x.data_ptr(), out.data_ptr(), n_rows, n,
                                n_segments, inv, build.stream(x)), "paa")
    build.count_launch(paa)
    return out


paa.launches = 0
