"""Mixture-of-Experts layer: top-k routing, capacity dispatch, shared experts.

The port's copy of ``src/repro/models/moe.py``. Each token copy's
*position within its expert* comes from an exclusive cumsum over the
token axis ([T, E] int, linear memory); token rows are scattered into an
[E·C, D] buffer, the stacked experts run as batched matmuls over it, and
the rows are gathered back. Copies past the capacity C are dropped, as in
GShard/Switch capacity-factor routing. The reference drops them with a
``mode="drop"`` scatter to row E·C; here the buffer has that row as a
sentinel and it is sliced off.

Routing follows DBRX/DeepSeek-MoE: softmax router in f32, top-k with
renormalized weights, optional shared experts applied densely,
Switch-style load-balance auxiliary loss and router z-loss.

Parity with the reference (its code, not its docstring: positions are
counted over all B·S tokens, the running count carried across the k
slots):

* the top-k is a stable descending sort of the f32 probabilities, so
  equal probabilities take the lower expert first, as ``lax.top_k`` does
  (``torch.topk`` leaves that order unspecified);
* the capacity is ``max(8, max(k, round(t·k·cf/E)))`` with Python's
  ``round`` (half to even), ``t`` the tokens of the call (B in decode);
* the weighted combine is summed over k in f32 and cast once, as jax
  sums a bf16 ``reduce_sum``.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from .layers import act_fn, mlp_apply, mlp_specs
from .params import ParamSpec
from .sharding_utils import constrain, unshard_fsdp

__all__ = ["MoEConfig", "capacity", "dispatch", "moe_apply", "moe_loss",
           "moe_specs"]


class MoEConfig(NamedTuple):
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared: int = 0  # shared experts (deepseek), each of d_ff_expert
    capacity_factor: float = 1.25
    router_z_loss: float = 1e-3
    aux_loss_weight: float = 1e-2


def moe_specs(d_model: int, cfg: MoEConfig, dtype) -> Dict[str, Any]:
    """The f32 router [d_model, E] and the experts stacked [E, d, f] under
    the logical axis 'experts' (``ModelConfig.active_param_count`` counts
    by that name)."""
    e, f = cfg.num_experts, cfg.d_ff_expert
    specs: Dict[str, Any] = {
        "router": ParamSpec((d_model, e), ("embed", None),
                            dtype=torch.float32, init="scaled",
                            fan_in_axes=(0,)),
        "wi_gate": ParamSpec((e, d_model, f), ("experts", "fsdp", "mlp"),
                             dtype=dtype, init="scaled", fan_in_axes=(1,)),
        "wi_up": ParamSpec((e, d_model, f), ("experts", "fsdp", "mlp"),
                           dtype=dtype, init="scaled", fan_in_axes=(1,)),
        "wo": ParamSpec((e, f, d_model), ("experts", "mlp", "fsdp"),
                        dtype=dtype, init="scaled", fan_in_axes=(1,)),
    }
    if cfg.num_shared > 0:
        specs["shared"] = mlp_specs(d_model, cfg.num_shared * f, dtype)
    return specs


def _route(logits: torch.Tensor, cfg: MoEConfig
           ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """Top-k routing. logits [T, E] -> (weights [T, K] f32, idx [T, K]
    int64, aux)."""
    logits = logits.float()
    probs = torch.softmax(logits, dim=-1)
    srt, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, idx = srt[:, :cfg.top_k], order[:, :cfg.top_k]
    total = weights[:, 0]
    for j in range(1, cfg.top_k):  # left to right, as XLA sums k terms
        total = total + weights[:, j]
    weights = weights / total.clamp_min(1e-9)[:, None]
    # Switch aux loss: E * sum_e (fraction dispatched_e * mean prob_e)
    t = logits.shape[0]
    counts = F.one_hot(idx, cfg.num_experts).sum(dim=(0, 1)).float()
    frac = counts / (t * cfg.top_k)
    mean_prob = probs.mean(dim=0)
    aux_loss = cfg.num_experts * torch.sum(frac * mean_prob)
    lse = torch.logsumexp(logits, dim=-1)
    aux = {
        "moe_aux_loss": aux_loss,
        "moe_z_loss": torch.mean(lse * lse),
        "moe_expert_frac_max": frac.max(),
    }
    return weights, idx, aux


def capacity(t: int, cfg: MoEConfig) -> int:
    """Rows per expert for a call over ``t`` tokens (static)."""
    k, e = cfg.top_k, cfg.num_experts
    return max(8, int(max(k, round(t * k * cfg.capacity_factor / e))))


def dispatch(idx: torch.Tensor, num_experts: int, cap: int
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """idx [T, K] -> (pos [T, K], keep [T, K], dest [T, K]): each copy's
    position within its expert in token-major order (an exclusive cumsum
    per slot, the running count carried across slots), whether it fits
    the capacity, and its buffer row (E·cap for a dropped copy)."""
    e = num_experts
    running = torch.zeros(e, dtype=torch.int64, device=idx.device)
    pos_list = []
    for kk in range(idx.shape[1]):
        mask_k = F.one_hot(idx[:, kk], e)  # [T, E]
        within = torch.cumsum(mask_k, dim=0) - mask_k  # exclusive cumsum
        pos_list.append(torch.gather(within + running[None, :], 1,
                                     idx[:, kk:kk + 1])[:, 0])
        running = running + mask_k.sum(dim=0)
    pos = torch.stack(pos_list, dim=1)
    keep = pos < cap
    dest = torch.where(keep, idx * cap + pos, torch.full_like(pos, e * cap))
    return pos, keep, dest


def moe_apply(params, x: torch.Tensor, cfg: MoEConfig, *,
              act: str = "silu") -> Tuple[torch.Tensor,
                                          Dict[str, torch.Tensor]]:
    """x [B, S, D] -> (out [B, S, D], aux): the router and its softmax in
    f32, the experts in x's dtype over capacity buffers."""
    b, s, d = x.shape
    t = b * s
    # on a mesh the routing, the capacity positions (a cumsum over every
    # token) and the index scatter and gather of the dispatch have no
    # sharded form: the token rows are replicated over every rank first
    xt = constrain(x.reshape(t, d), None, None)
    e, k = cfg.num_experts, cfg.top_k
    dtype = x.dtype

    logits = torch.matmul(xt.float(), params["router"].float())
    weights, idx, aux = _route(logits, cfg)
    cap = capacity(t, cfg)
    _, keep, dest = dispatch(idx, e, cap)

    # scatter token rows into expert buffers [E*C (+ the drop row), D]
    dest_flat = dest.reshape(t * k)
    buf = torch.zeros(e * cap + 1, d, dtype=dtype, device=x.device)
    # out of place: on a mesh the rows are a DTensor and the buffer is not
    buf = buf.index_put((dest_flat,), xt.repeat_interleave(k, dim=0))
    # expert-parallel: buffers live where the expert weights live
    buf = constrain(buf[:e * cap].reshape(e, cap, d), "experts", None, None)
    wg = unshard_fsdp(params["wi_gate"], "experts", "fsdp", "mlp")
    wu = unshard_fsdp(params["wi_up"], "experts", "fsdp", "mlp")
    wo = unshard_fsdp(params["wo"], "experts", "mlp", "fsdp")

    # serving: the gate activated and freed before the up projection, two
    # [E, C, f] buffers live, not three (jamba's are 3.8 GB each at 8224
    # tokens); training keeps the activation for the product's backward
    h = act_fn(act)(torch.matmul(buf, wg.to(dtype)))
    up = torch.matmul(buf, wu.to(dtype))
    h = h * up if h.requires_grad or up.requires_grad else h.mul_(up)
    del up
    out_buf = constrain(torch.matmul(h, wo.to(dtype)), "experts", None,
                        None).reshape(e * cap, d)

    # gather back, weight, sum over the k copies
    gathered = out_buf[dest_flat.clamp_max(e * cap - 1)]
    gathered = torch.where(keep.reshape(t * k, 1), gathered,
                           torch.zeros((), dtype=dtype, device=x.device))
    wflat = weights.reshape(t * k, 1).to(dtype)
    out = (gathered * wflat).reshape(t, k, d).float().sum(dim=1).to(dtype)

    if cfg.num_shared > 0:
        out = out + mlp_apply(params["shared"], xt, act=act)

    aux["moe_dropped_frac"] = 1.0 - keep.float().mean()
    return out.reshape(b, s, d), aux


def moe_loss(aux: Dict[str, torch.Tensor], cfg: MoEConfig) -> torch.Tensor:
    return (cfg.aux_loss_weight * aux["moe_aux_loss"]
            + cfg.router_z_loss * aux["moe_z_loss"])
