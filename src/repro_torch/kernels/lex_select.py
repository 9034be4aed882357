"""``lex_select``: the exact (d, id) selection shared by K4 and K6.

Replaces the selection stage of ``src/repro/kernels/topk.py``
(``lex_min_select``, kk rounds of min-extraction in VMEM, which the TPU
kernels of K4 and K6 both run) with ``csrc/lex_select.cu``. One block
per lane runs a radix select on a 64-bit key (the distance's bits in
sign-aware order, then the id), finds the kk-th smallest key exactly,
gathers the keys below it and sorts them: up to 1024 keys in shared
memory, more as runs in shared memory merged through a scratch in device
memory. The call is bound by bytes: the [B, R] scores are read once, and
they come from L2 when a score pass has just written them.
"""

from __future__ import annotations

import torch

from . import ref


def lex_select(d: torch.Tensor, ids: torch.Tensor, kk: int) -> tuple:
    """Per lane of the scores d [B, R] f32 against the shared ids [R]
    int32, the kk lexicographically smallest (d, id) pairs, sorted:
    d [B, kk] f32, ids [B, kk] int32. A slot with a negative id counts
    as (inf, id), so masked slots come out as (inf, -1). Precondition:
    real ids are distinct. A CPU tensor takes the plain version; CUDA
    tensors launch the kernel, any 1 <= kk <= R."""
    if kk > d.shape[1]:
        raise ValueError(f"kk={kk} exceeds the pool of {d.shape[1]} rows")
    if kk < 1:
        raise ValueError(f"lex_select needs kk >= 1, got {kk}")
    if d.device.type == "cpu":
        return ref.ref_lex_select(d, ids, kk)
    from . import build

    build.require(d, (torch.float32,), "lex_select scores", 2)
    build.require(ids, (torch.int32,), "lex_select ids", 1)
    b, r = d.shape
    if ids.shape[0] != r:
        raise ValueError(f"lex_select shapes disagree: scores {d.shape}, "
                         f"ids {ids.shape}")
    out_d = torch.empty((b, kk), dtype=torch.float32, device=d.device)
    out_i = torch.empty((b, kk), dtype=torch.int32, device=d.device)
    lib = build.library("lex_select")
    # [B, kk] buffers of 64-bit keys for the sort's merge passes, as many
    # as the library asks for at this kk (none while it sorts in shared
    # memory)
    n = lib.lex_select_scratch_buffers(kk)
    scratch = torch.empty((n, b, kk), dtype=torch.int64,
                          device=d.device) if n else None
    with torch.cuda.device(d.device):
        build.check(lib.lex_select_f32(
            d.data_ptr(), ids.data_ptr(), out_d.data_ptr(), out_i.data_ptr(),
            b, r, kk, None if scratch is None else scratch.data_ptr(),
            build.stream(d)), "lex_select")
    build.count_launch(lex_select)
    return out_d, out_i


lex_select.launches = 0
