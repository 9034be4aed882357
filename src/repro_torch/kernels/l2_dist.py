"""K3 ``l2``: fused squared Euclidean distances, the brute-force scan.

Replaces ``src/repro/kernels/l2_dist.py`` (``l2_pallas`` /
``_l2_kernel``) with ``csrc/l2_dist.cu``. At the main path's shapes
(100 lanes against the whole collection) the card is bound by f32
operations: a tiled SIMT GEMM in IEEE FMAs (no TF32, no tensor cores,
because exact answers compare these distances) that squares the staged
tiles for both norm terms in the same pass and clamps at 0.
"""

from __future__ import annotations

import torch

from . import ref


def l2(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """|q|^2 - 2 q.x + |x|^2 clamped at 0: q [B, n], x [M, n] -> [B, M]
    f32. A CPU tensor takes the plain version; CUDA rows (f32 or bf16,
    contiguous) launch the kernel, which reads q as f32."""
    if q.device.type == "cpu":
        return ref.ref_l2(q, x)
    from . import build

    build.require(x, (torch.float32, torch.bfloat16), "l2 x", 2)
    qf = q.float().contiguous()
    build.require(qf, (torch.float32,), "l2 q", 2)
    b, n = qf.shape
    m = x.shape[0]
    if x.shape[1] != n:
        raise ValueError(f"l2 shapes disagree: q {q.shape}, x {x.shape}")
    out = torch.empty((b, m), dtype=torch.float32, device=x.device)
    lib = build.library("l2_dist")
    fn = lib.l2_f32 if x.dtype == torch.float32 else lib.l2_bf16
    with torch.cuda.device(x.device):
        build.check(fn(qf.data_ptr(), x.data_ptr(), out.data_ptr(), b, m, n,
                       build.stream(x)), "l2")
    build.count_launch(l2)
    return out


l2.launches = 0
