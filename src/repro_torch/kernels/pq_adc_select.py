"""K6 ``pq_adc_select``: fused cooperative ADC score + select.

Replaces ``src/repro/kernels/pq_adc_select.py`` (``pq_adc_select_pallas``
/ ``_pq_select_kernel`` with ``lex_min_select``) with
``csrc/pq_adc_select.cu``. Every lane scores every pooled code row
against its own table, staged in shared memory, and keeps its kk best
(d, id) pairs with K4's warp sort and packed keys (``csrc/common.cuh``),
so the [B, R] ADC matrix never reaches device memory. The running list
of a lane holds exactly kk keys, up to 1024, which covers the pq
corner's kk = 2 * k * rerank = 800 at k = 100 and the default rerank of
4; a tile enters it by binary-search insertion, not by K4's bitonic
merge over a power-of-two list. The pool is cut into slices so that
about one block per SM runs; a second pass merges the slices' lists per
lane.
"""

from __future__ import annotations

import torch

from . import ref

# the running list of a lane holds at most this many (d, id) keys
MAX_KK = 1024
# lanes per block (kLanes in csrc/pq_adc_select.cu)
LANES_PER_BLOCK = 8
# the table a lane stages in shared memory holds at most m * K floats
MAX_TABLE = 16 * 256


def pq_adc_select(codes: torch.Tensor, luts: torch.Tensor,
                  ids: torch.Tensor, kk: int) -> tuple:
    """Per lane, the kk lexicographically smallest (d, id) pairs over the
    pooled code rows [R, m] scored against luts [B, m, K], sorted:
    d [B, kk] f32, ids [B, kk] int32. Masked slots carry id -1 and score
    (inf, -1). Precondition: real ids are distinct in the pool. A CPU
    tensor takes the plain version; CUDA tensors launch the kernel,
    which holds kk <= MAX_KK and m * K <= MAX_TABLE."""
    if kk > codes.shape[0]:
        raise ValueError(f"kk={kk} exceeds the pool of {codes.shape[0]} rows")
    if codes.device.type == "cpu":
        return ref.ref_pq_adc_select(codes, luts, ids, kk)
    from . import build

    if not 1 <= kk <= MAX_KK:
        raise ValueError(f"pq_adc_select keeps at most {MAX_KK} candidates "
                         f"per lane, asked for kk={kk}")
    build.require(codes, (torch.uint8,), "pq_adc_select codes", 2)
    lf = luts.float().contiguous()
    build.require(lf, (torch.float32,), "pq_adc_select luts", 3)
    build.require(ids, (torch.int32,), "pq_adc_select ids", 1)
    b, m, k = lf.shape
    r = codes.shape[0]
    if codes.shape[1] != m or ids.shape[0] != r or k > 256 \
            or m * k > MAX_TABLE:
        raise ValueError(f"pq_adc_select shapes disagree: codes "
                         f"{codes.shape}, luts {luts.shape}, ids {ids.shape} "
                         f"(K <= 256, m * K <= {MAX_TABLE})")
    sms = torch.cuda.get_device_properties(codes.device).multi_processor_count
    lane_blocks = -(-b // LANES_PER_BLOCK)
    # one block per SM fits the shared memory of a full list; a slice
    # shorter than 2 kk rows would mostly fill lists
    splits = max(1, min(sms // lane_blocks, r // max(2 * kk, 1024)))
    partial = torch.empty((splits, b, kk), dtype=torch.int64,
                          device=codes.device)
    out_d = torch.empty((b, kk), dtype=torch.float32, device=codes.device)
    out_i = torch.empty((b, kk), dtype=torch.int32, device=codes.device)
    lib = build.library("pq_adc_select")
    with torch.cuda.device(codes.device):
        build.check(lib.pq_adc_select_u8(
            codes.data_ptr(), lf.data_ptr(), ids.data_ptr(),
            partial.data_ptr(), out_d.data_ptr(), out_i.data_ptr(), b, r, m,
            k, kk, splits, build.stream(codes)), "pq_adc_select")
    pq_adc_select.launches += 1
    return out_d, out_i


pq_adc_select.launches = 0
