"""Shared neural building blocks: norms, the gated MLP, embeddings, RoPE,
softcap, the cross-entropy loss.

The port's copy of ``src/repro/models/layers.py``, cast for cast.
``<name>_specs(...)`` returns a ParamSpec tree, ``<name>_apply(params, x,
...)`` is a function on tensors whose ``params`` is read by key (a dict or
a :class:`~repro_torch.models.params.Params`). Compute runs in the
config's compute dtype (bf16 by default) with f32 where the reference
takes it: norm statistics, softcap, softmax, rotary angles.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .params import ParamSpec
from .sharding_utils import constrain, unshard_fsdp

__all__ = ["act_fn", "cross_entropy", "dense_specs", "embed_apply",
           "embed_specs",
           "logits_apply", "mlp_apply", "mlp_specs", "rmsnorm_apply",
           "rmsnorm_specs", "rope", "rounded", "softcap"]


# ---------------------------------------------------------------------------
# activations / misc
# ---------------------------------------------------------------------------

def rounded(v: float, dtype) -> float:
    """``v`` rounded to ``dtype``: the value a weakly typed Python scalar
    takes in the reference's arithmetic on a tensor of that dtype. A
    Python float, so no tensor is copied to the device."""
    return float(torch.tensor(v, dtype=dtype))


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    """Gemma-2 style logit soft capping: cap * tanh(x / cap), in f32, cast
    back to the input's dtype."""
    if cap is None:
        return x
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)


def _gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


def act_fn(name: str):
    return {"silu": F.silu, "gelu": _gelu_tanh, "relu": F.relu}[name]


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

def rmsnorm_specs(dim: int, dtype=torch.float32) -> Dict[str, ParamSpec]:
    return {"scale": ParamSpec((dim,), ("embed",), dtype=dtype, init="zeros")}


def rmsnorm_apply(params, x: torch.Tensor, eps: float = 1e-6, *,
                  plus_one: bool = True) -> torch.Tensor:
    """RMSNorm with the (1 + scale) weight (llama/gemma convention).
    Statistics in f32 whatever the compute dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    xn = xf * torch.rsqrt(var + eps)
    scale = params["scale"].float()
    w = (1.0 + scale) if plus_one else scale
    return (xn * w).to(x.dtype)


# ---------------------------------------------------------------------------
# Gated MLP
# ---------------------------------------------------------------------------

def dense_specs(d_in: int, d_out: Tuple[int, ...], logical_in: str,
                logical_out: Tuple[str, ...], dtype, *, bias: bool = False
                ) -> Dict[str, ParamSpec]:
    """A dense layer's weight [d_in, *d_out] (and its zero bias)."""
    shape = (d_in,) + tuple(d_out)
    logical = (logical_in,) + tuple(logical_out)
    specs = {"w": ParamSpec(shape, logical, dtype=dtype, init="scaled",
                            fan_in_axes=(0,))}
    if bias:
        specs["b"] = ParamSpec(tuple(d_out), tuple(logical_out), dtype=dtype,
                               init="zeros")
    return specs


def mlp_specs(d_model: int, d_ff: int, dtype) -> Dict[str, Any]:
    """Gated MLP (gate, up, down)."""
    return {
        "wi_gate": ParamSpec((d_model, d_ff), ("fsdp", "mlp"), dtype=dtype,
                             init="scaled", fan_in_axes=(0,)),
        "wi_up": ParamSpec((d_model, d_ff), ("fsdp", "mlp"), dtype=dtype,
                           init="scaled", fan_in_axes=(0,)),
        "wo": ParamSpec((d_ff, d_model), ("mlp", "fsdp"), dtype=dtype,
                        init="scaled", fan_in_axes=(0,)),
    }


def mlp_apply(params, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    dtype = x.dtype
    wg = unshard_fsdp(params["wi_gate"], "fsdp", "mlp").to(dtype)
    wu = unshard_fsdp(params["wi_up"], "fsdp", "mlp").to(dtype)
    wo = unshard_fsdp(params["wo"], "mlp", "fsdp").to(dtype)
    gate = torch.matmul(x, wg)
    up = torch.matmul(x, wu)
    h = act_fn(act)(gate) * up
    return torch.matmul(h, wo)


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------

def embed_specs(vocab: int, d_model: int, dtype) -> Dict[str, ParamSpec]:
    return {
        "embedding": ParamSpec(
            (vocab, d_model), ("vocab", "embed"), dtype=dtype,
            init="embed", scale=1.0,
        )
    }


def embed_apply(params, tokens: torch.Tensor, compute_dtype) -> torch.Tensor:
    # on a mesh the table is gathered over 'model' first: DTensor's lookup
    # in a vocab-sharded table is a masked partial sum, whose mask is
    # spent by its first reduction (a recomputed block reduces it again)
    # and whose gradient cannot be redistributed back to it
    table = constrain(params["embedding"], None, None)
    return F.embedding(tokens.long(), table).to(compute_dtype)


def logits_apply(params, x: torch.Tensor, *, tied: bool, head_params=None,
                 final_softcap: Optional[float] = None) -> torch.Tensor:
    """The LM head in the compute dtype (bf16 logits for a bf16 model),
    then the f32 softcap cast back to it."""
    if tied:
        logits = torch.matmul(x, params["embedding"].to(x.dtype).t())
    else:
        w = unshard_fsdp(head_params["w"], "fsdp", "vocab").to(x.dtype)
        logits = torch.matmul(x, w)
    return softcap(logits, final_softcap)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """Rotary embeddings, half-split (not interleaved).

    x: [..., seq, heads, head_dim]; positions: broadcastable to [..., seq].
    Angles and the rotation in f32, the result cast back."""
    half = x.shape[-1] // 2
    freq = torch.arange(half, dtype=torch.float32, device=x.device)
    inv_freq = 1.0 / (theta ** (freq / half))
    angles = positions[..., None].float() * inv_freq
    sin = torch.sin(angles)[..., None, :]  # broadcast over heads
    cos = torch.cos(angles)[..., None, :]
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None, z_loss: float = 0.0
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Token-mean cross entropy in f32 with an optional z-loss: logits
    [..., V], labels [...] -> (loss, {loss, ntokens, ppl_proxy}). Masked
    tokens weigh 0; the mean is over max(mask.sum(), 1)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - ll
    if z_loss:
        nll = nll + rounded(z_loss, torch.float32) * torch.square(lse)
    if mask is None:
        mask = torch.ones_like(nll)
    mask = mask.float()
    denom = torch.clamp_min(mask.sum(), 1.0)
    loss = (nll * mask).sum() / denom
    metrics = {"loss": loss, "ntokens": mask.sum(), "ppl_proxy": loss}
    return loss, metrics
