"""Error-feedback int8 gradient compression.

The port's copy of the single-card half of ``src/repro/train/compress.py``:
each gradient leaf plus its carried error is quantized to int8 with one
per-tensor scale (max |x| / 127), dequantized, and the difference is
carried to the next step (Seide et al. / EF-SGD), so the quantization
noise does not bias convergence. ``torch.round`` and ``jnp.round`` both
round half to even, so the quantized values equal the reference's bit
for bit. The collective ``compressed_psum`` (an int32 sum of int8 codes
across cards) waits for the multi-GPU slice.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

__all__ = ["ef_quantize", "init_error_state"]


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
    return {k: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
            for k, g in leaves.items()}
