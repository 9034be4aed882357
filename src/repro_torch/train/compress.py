"""Error-feedback int8 gradient compression.

The port's copy of the single-card half of ``src/repro/train/compress.py``:
each gradient leaf plus its carried error is quantized to int8 with one
per-tensor scale (max |x| / 127), dequantized, and the difference is
carried to the next step (Seide et al. / EF-SGD), so the quantization
noise does not bias convergence. ``torch.round`` and ``jnp.round`` both
round half to even, so the quantized values equal the reference's bit
for bit. ``compressed_psum`` is the wire-honest int8 all-reduce across
ranks: one scalar max agrees on a shared scale, then the int8 codes are
summed as int32.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

__all__ = ["compressed_psum", "ef_quantize", "init_error_state"]


def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp_min(torch.max(torch.abs(x)), 1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


@torch.no_grad()
def ef_quantize(grads: Dict[str, torch.Tensor],
                errors: Dict[str, torch.Tensor]
                ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(grads + errors) -> (the quantized-dequantized grads in each
    gradient's dtype, the new f32 errors), leaf by leaf."""
    out, err = {}, {}
    for k, g in grads.items():
        gf = g.float() + errors[k]
        q, s = _quantize(gf)
        dq = _dequantize(q, s)
        out[k] = dq.to(g.dtype)
        err[k] = gf - dq
    return out, err


def init_error_state(grads_like) -> Dict[str, torch.Tensor]:
    """f32 zeros shaped like each leaf (a Model's reference leaves or a
    dict of tensors)."""
    leaves = (grads_like.reference_leaves()
              if hasattr(grads_like, "reference_leaves") else grads_like)
    return {k: torch.zeros_like(g, dtype=torch.float32)
            for k, g in leaves.items()}


@torch.no_grad()
def compressed_psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group`` (a process group, a
    1-D DeviceMesh such as ``mesh["data"]``, or None for the world), with
    the payload int8 on the wire: an ``all_reduce(MAX)`` of max |x| in f32
    gives every rank one scale (max / 127), each rank's codes are summed
    as int32 by one ``all_reduce(SUM)`` (no overflow below 2^24 ranks),
    and the sum is dequantized in f32 and cast back to ``x``'s dtype. At
    one rank it is the local quantize-dequantize, bit for bit."""
    import torch.distributed as dist

    if hasattr(group, "get_group"):
        group = group.get_group()
    xf = x.float()
    gmax = torch.max(torch.abs(xf)).clone()
    dist.all_reduce(gmax, op=dist.ReduceOp.MAX, group=group)
    scale = torch.clamp_min(gmax, 1e-12) / 127.0
    total = torch.clamp(torch.round(xf / scale), -127, 127).to(
        torch.int8).to(torch.int32)
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    return (total.float() * scale).to(x.dtype)
