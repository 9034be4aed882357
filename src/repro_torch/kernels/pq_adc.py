"""K5 ``pq_adc_batch``: the PQ asymmetric distance (ADC) scan.

Replaces ``src/repro/kernels/pq_adc.py`` (``pq_adc_pallas`` /
``_adc_kernel``) with ``csrc/pq_adc.cu``. The TPU kernel contracted a
one-hot expansion of the codes on the MXU because the TPU lacks fast
gathers; on the card a block stages one lane's table in shared memory
and each thread gathers and sums its row's m entries, left to right
from zero as the plain version does, so the two agree bit for bit. The
call is bound by bytes: the uint8 codes are read once and one f32 is
written per row. The same kernel serves one query (``ops.pq_adc``), the
per-lane rows of the solo pq refinement step and a row set shared by
every lane.
"""

from __future__ import annotations

import torch

from . import ref


def pq_adc_batch(codes: torch.Tensor, luts: torch.Tensor) -> torch.Tensor:
    """ADC distances: luts [B, m, K] f32 per-lane tables; codes [M, m]
    (scored against every lane) or [B, M, m] (per-lane rows), values in
    [0, K) -> [B, M] f32. A CPU tensor takes the plain version; CUDA
    codes must be uint8 (the store's payload) and launch the kernel."""
    if codes.device.type == "cpu":
        return ref.ref_pq_adc_batch(codes, luts)
    from . import build

    shared = codes.dim() == 2
    build.require(codes, (torch.uint8,), "pq_adc codes", codes.dim())
    lf = luts.float().contiguous()
    build.require(lf, (torch.float32,), "pq_adc luts", 3)
    b, m, k = lf.shape
    if codes.shape[-1] != m or not (shared or codes.shape[0] == b) \
            or codes.dim() not in (2, 3) or k > 256:
        raise ValueError(f"pq_adc shapes disagree: codes {codes.shape}, "
                         f"luts {luts.shape} (K <= 256)")
    rows = codes.shape[-2]
    out = torch.empty((b, rows), dtype=torch.float32, device=codes.device)
    lib = build.library("pq_adc")
    with torch.cuda.device(codes.device):
        build.check(lib.pq_adc_u8(codes.data_ptr(), lf.data_ptr(),
                                  out.data_ptr(), b, rows, m, k, int(shared),
                                  build.stream(codes)), "pq_adc")
    build.count_launch(pq_adc_batch)
    return out


pq_adc_batch.launches = 0
