"""K4 ``coop_score_select``: cooperative score, then exact select.

Replaces ``src/repro/kernels/topk.py`` (``coop_score_select_pallas`` /
``_coop_topk_kernel`` with ``lex_min_select``) with two kernels. The
score pass (``csrc/topk.cu``) is K3's register-tiled f32 GEMM
(``csrc/gemm_tile.cuh``) with the cached row norms passed in: it writes
every lane's distances to every pooled row into a scratch matrix
[B, R], bound by f32 operations. :func:`lex_select.lex_select` then
keeps each lane's kk smallest (d, id) pairs; at the main path's
B = 100, R = 25,600 the matrix is 10 MB and stays in L2 between the two.
"""

from __future__ import annotations

import torch

from . import ref
from .lex_select import lex_select


def coop_score_select(q: torch.Tensor, rows: torch.Tensor,
                      row_norms: torch.Tensor, ids: torch.Tensor,
                      kk: int) -> tuple:
    """Per lane, the kk lexicographically smallest (d, id) pairs over the
    pooled rows, sorted: d [B, kk] f32, ids [B, kk] int32. Masked slots
    carry id -1 and score (inf, -1). Precondition: real ids are distinct
    in the pool. A CPU tensor takes the plain version; CUDA tensors
    launch the kernels, any kk up to the pool."""
    if kk > rows.shape[0]:
        raise ValueError(f"kk={kk} exceeds the pool of {rows.shape[0]} rows")
    if q.device.type == "cpu":
        return ref.ref_coop_score_select(q, rows, row_norms, ids, kk)
    from . import build

    build.require(rows, (torch.float32, torch.bfloat16),
                  "coop_score_select rows", 2)
    qf = q.float().contiguous()
    build.require(qf, (torch.float32,), "coop_score_select q", 2)
    build.require(row_norms, (torch.float32,), "coop_score_select norms", 1)
    build.require(ids, (torch.int32,), "coop_score_select ids", 1)
    b, n = qf.shape
    r = rows.shape[0]
    if rows.shape[1] != n or row_norms.shape[0] != r or ids.shape[0] != r:
        raise ValueError(f"coop_score_select shapes disagree: q {q.shape}, "
                         f"rows {rows.shape}, norms {row_norms.shape}, "
                         f"ids {ids.shape}")
    scores = torch.empty((b, r), dtype=torch.float32, device=q.device)
    lib = build.library("topk")
    fn = lib.coop_score_f32 if rows.dtype == torch.float32 \
        else lib.coop_score_bf16
    with torch.cuda.device(q.device):
        build.check(fn(qf.data_ptr(), rows.data_ptr(), row_norms.data_ptr(),
                       scores.data_ptr(), b, r, n, build.stream(q)),
                    "coop_score_select")
    build.count_launch(coop_score_select)
    return lex_select(scores, ids, kk)


coop_score_select.launches = 0
