"""K4 ``coop_score_select``: fused cooperative score + select.

Replaces ``src/repro/kernels/topk.py`` (``coop_score_select_pallas`` /
``_coop_topk_kernel`` with ``lex_min_select``) with ``csrc/topk.cu``.
On the card the call is bound by f32 operations (every lane scores every
pooled row). A block owns eight lanes, one warp each, and a slice of the
pool, walked in tiles of 32 rows staged in shared memory for all of
them; each warp sorts its tile's 64-bit (d, id) keys with shuffles and
merges them into its running list in shared memory with a bitonic merge,
so the [B, R] distances never reach device memory. A second pass merges
the slices' lists per lane. The pool is cut into enough slices to give
every SM two blocks.
"""

from __future__ import annotations

import torch

from . import ref

# the running list of a lane holds at most this many (d, id) keys
MAX_KK = 256
# lanes per block (kLanes in csrc/topk.cu) and the smallest pool slice,
# which together set how many slices the pool is cut into
LANES_PER_BLOCK = 8
MIN_ROWS_PER_SLICE = 1024


def coop_score_select(q: torch.Tensor, rows: torch.Tensor,
                      row_norms: torch.Tensor, ids: torch.Tensor,
                      kk: int) -> tuple:
    """Per lane, the kk lexicographically smallest (d, id) pairs over the
    pooled rows, sorted: d [B, kk] f32, ids [B, kk] int32. Masked slots
    carry id -1 and score (inf, -1). Precondition: real ids are distinct
    in the pool. A CPU tensor takes the plain version; CUDA tensors
    launch the kernel, which holds kk <= MAX_KK."""
    if kk > rows.shape[0]:
        raise ValueError(f"kk={kk} exceeds the pool of {rows.shape[0]} rows")
    if q.device.type == "cpu":
        return ref.ref_coop_score_select(q, rows, row_norms, ids, kk)
    from . import build

    if not 1 <= kk <= MAX_KK:
        raise ValueError(f"coop_score_select keeps at most {MAX_KK} "
                         f"candidates per lane, asked for kk={kk}")
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
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    lane_blocks = -(-b // LANES_PER_BLOCK)
    splits = max(1, min(-(-2 * sms // lane_blocks),
                        -(-r // MIN_ROWS_PER_SLICE)))
    partial = torch.empty((splits, b, kk), dtype=torch.int64,
                          device=q.device)
    out_d = torch.empty((b, kk), dtype=torch.float32, device=q.device)
    out_i = torch.empty((b, kk), dtype=torch.int32, device=q.device)
    lib = build.library("topk")
    fn = lib.coop_score_select_f32 if rows.dtype == torch.float32 \
        else lib.coop_score_select_bf16
    with torch.cuda.device(q.device):
        build.check(fn(qf.data_ptr(), rows.data_ptr(), row_norms.data_ptr(),
                       ids.data_ptr(), partial.data_ptr(), out_d.data_ptr(),
                       out_i.data_ptr(), b, r, n, kk, splits,
                       build.stream(q)), "coop_score_select")
    coop_score_select.launches += 1
    return out_d, out_i


coop_score_select.launches = 0
