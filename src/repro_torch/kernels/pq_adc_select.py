"""K6 ``pq_adc_select``: cooperative ADC score, then exact select.

Replaces ``src/repro/kernels/pq_adc_select.py`` (``pq_adc_select_pallas``
/ ``_pq_select_kernel`` with ``lex_min_select``) with two kernels: K5's
shared-row-set scan (``csrc/pq_adc.cu``, the table of each lane staged
in shared memory, bit-equal to the plain ADC) writes every lane's ADC
distance to every pooled code row into a [B, R] matrix, and
:func:`lex_select.lex_select` keeps each lane's kk smallest (d, id)
pairs (the pq corner's kk = 2 * k * rerank is 800 at k = 100 and the
default rerank of 4; any kk up to the pool). The selection's key orders
negative distances too, so any finite table works.
"""

from __future__ import annotations

import torch

from . import build, ref
from .lex_select import lex_select
from .pq_adc import pq_adc_batch


def pq_adc_select(codes: torch.Tensor, luts: torch.Tensor,
                  ids: torch.Tensor, kk: int) -> tuple:
    """Per lane, the kk lexicographically smallest (d, id) pairs over the
    pooled code rows [R, m] scored against luts [B, m, K], sorted:
    d [B, kk] f32, ids [B, kk] int32. Masked slots carry id -1 and score
    (inf, -1). Precondition: real ids are distinct in the pool. A CPU
    tensor takes the plain version; CUDA tensors launch the kernels,
    any kk up to the pool."""
    if kk > codes.shape[0]:
        raise ValueError(f"kk={kk} exceeds the pool of {codes.shape[0]} rows")
    if codes.device.type == "cpu":
        return ref.ref_pq_adc_select(codes, luts, ids, kk)
    if codes.dim() != 2 or ids.shape != (codes.shape[0],):
        raise ValueError(f"pq_adc_select shapes disagree: codes "
                         f"{codes.shape}, ids {ids.shape}")
    scores = pq_adc_batch(codes, luts)
    build.count_launch(pq_adc_select)
    return lex_select(scores, ids, kk)


pq_adc_select.launches = 0
