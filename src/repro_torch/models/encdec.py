"""Encoder-decoder backbone (seamless-m4t-medium, stub frontend).

The port's copy of ``src/repro/models/encdec.py``. The modality frontend
is a stub: the encoder takes precomputed audio frame embeddings [B, F,
d_model] through one projection, then runs a bidirectional transformer
over the frames. The decoder is a causal transformer with cross
attention to the encoder's output. The reference stacks each side's
layers along a leading axis and scans; here the parameters stay stacked
and the scan is a Python loop over layer l's slices of them
(``params.unstack``). The cache is stacked too, [L, ...] per entry:
the decoder's self keys and values ``k``/``v`` [L, B, cap, Kv, D] and the
encoder's cross keys and values ``ck``/``cv`` [L, B, F, Kv, D], written
in place. Only ``k``/``v`` grow to a serving capacity: ``ck``/``cv``
keep the frames' extent, as the reference's generate pads only
``k``/``v``. Cross attention is always the dense path; the self
attention takes the reference's dense or blockwise path by length.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig

from . import attention as attn_mod
from .layers import mlp_apply, mlp_specs, rmsnorm_apply, rmsnorm_specs
from .params import ParamSpec, unstack
from .sharding_utils import zeros
from .transformer import attn_config, remat, stack_specs

__all__ = ["alloc_cache", "dec_layer_specs", "decode_step", "decode_train",
           "enc_layer_specs", "encdec_cache_specs", "encdec_specs",
           "encode"]


def enc_layer_specs(cfg: ModelConfig) -> Dict[str, Any]:
    dt = cfg.param_dtype
    return {
        "ln1": rmsnorm_specs(cfg.d_model),
        "attn": attn_mod.attn_specs(attn_config(cfg), dt),
        "ln2": rmsnorm_specs(cfg.d_model),
        "mlp": mlp_specs(cfg.d_model, cfg.d_ff, dt),
    }


def dec_layer_specs(cfg: ModelConfig) -> Dict[str, Any]:
    dt = cfg.param_dtype
    return {
        "ln1": rmsnorm_specs(cfg.d_model),
        "self_attn": attn_mod.attn_specs(attn_config(cfg), dt),
        "ln_x": rmsnorm_specs(cfg.d_model),
        "cross_attn": attn_mod.attn_specs(attn_config(cfg), dt),
        "ln2": rmsnorm_specs(cfg.d_model),
        "mlp": mlp_specs(cfg.d_model, cfg.d_ff, dt),
    }


def encdec_specs(cfg: ModelConfig) -> Dict[str, Any]:
    return {
        "frontend_proj": ParamSpec(
            (cfg.d_model, cfg.d_model), ("fsdp", "embed"),
            dtype=cfg.param_dtype, init="scaled", fan_in_axes=(0,)),
        "encoder": stack_specs(enc_layer_specs(cfg), cfg.encoder_layers),
        "enc_norm": rmsnorm_specs(cfg.d_model),
        "decoder": stack_specs(dec_layer_specs(cfg), cfg.num_layers),
        "dec_norm": rmsnorm_specs(cfg.d_model),
    }


def _enc_layer(lp, h: torch.Tensor, cfg: ModelConfig,
               positions: torch.Tensor) -> torch.Tensor:
    a = rmsnorm_apply(lp["ln1"], h, cfg.norm_eps)
    a, _ = attn_mod.self_attention(lp["attn"], a, attn_config(cfg),
                                   causal=False, positions=positions)
    h = h + a
    m = rmsnorm_apply(lp["ln2"], h, cfg.norm_eps)
    return h + mlp_apply(lp["mlp"], m, act=cfg.act)


def encode(params, frames: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """frames [B, F, d_model] (the stub's embeddings) -> the encoder's
    output [B, F, d_model] in the compute dtype."""
    dtype = cfg.compute_dtype
    x = torch.matmul(frames.to(dtype), params["frontend_proj"].to(dtype))
    positions = torch.arange(frames.shape[1], device=frames.device)
    for lp in unstack(params["encoder"]):
        x = remat(lambda h, lp=lp: _enc_layer(lp, h, cfg, positions), cfg)(x)
    return rmsnorm_apply(params["enc_norm"], x, cfg.norm_eps)


def _dec_layer(lp, h: torch.Tensor, enc_out: torch.Tensor, cfg: ModelConfig,
               positions: torch.Tensor,
               entry: Optional[Dict[str, torch.Tensor]]) -> torch.Tensor:
    acfg = attn_config(cfg)
    a = rmsnorm_apply(lp["ln1"], h, cfg.norm_eps)
    a, (k, v) = attn_mod.self_attention(lp["self_attn"], a, acfg,
                                        causal=True, positions=positions)
    h = h + a
    c = rmsnorm_apply(lp["ln_x"], h, cfg.norm_eps)
    ck, cv = attn_mod.cross_kv(lp["cross_attn"], enc_out, acfg)
    c = attn_mod.cross_attention(lp["cross_attn"], c, (ck, cv), acfg)
    h = h + c
    m = rmsnorm_apply(lp["ln2"], h, cfg.norm_eps)
    h = h + mlp_apply(lp["mlp"], m, act=cfg.act)
    if entry is not None:
        s = k.shape[1]
        entry["k"][:, :s] = k.to(entry["k"].dtype)
        entry["v"][:, :s] = v.to(entry["v"].dtype)
        entry["ck"].copy_(ck)
        entry["cv"].copy_(cv)
    return h


def alloc_cache(cfg: ModelConfig, batch: int, capacity: int, frames: int,
                device) -> Dict[str, torch.Tensor]:
    """A zeroed decoder cache in the compute dtype: self keys and values
    of ``capacity`` positions, cross keys and values of ``frames``."""
    kv = (cfg.num_layers, batch, capacity, cfg.num_kv_heads, cfg.head_dim)
    xkv = (cfg.num_layers, batch, frames, cfg.num_kv_heads, cfg.head_dim)
    lay = ("layers", "batch", "seq", "kv_heads", "head_dim")
    return {n: zeros(shape, lay, cfg.compute_dtype, device)
            for n, shape in (("k", kv), ("v", kv), ("ck", xkv),
                             ("cv", xkv))}


def decode_train(params, enc_out: torch.Tensor, x: torch.Tensor,
                 cfg: ModelConfig, collect_cache: bool = False,
                 capacity: Optional[int] = None):
    """The teacher-forced decoder over embedded targets x [B, S, d_model]
    -> the dec_norm'd hidden states; with ``collect_cache`` also the cache
    (:func:`alloc_cache` at ``capacity``, S by default, and the frames'
    extent), filled in place."""
    positions = torch.arange(x.shape[1], device=x.device)
    cache = None
    if collect_cache:
        cache = alloc_cache(cfg, x.shape[0], capacity or x.shape[1],
                            enc_out.shape[1], x.device)
    for l, lp in enumerate(unstack(params["decoder"])):
        if cache is None:
            x = remat(lambda h, e, lp=lp: _dec_layer(
                lp, h, e, cfg, positions, None), cfg)(x, enc_out)
        else:
            x = _dec_layer(lp, x, enc_out, cfg, positions,
                           {n: t[l] for n, t in cache.items()})
    x = rmsnorm_apply(params["dec_norm"], x, cfg.norm_eps)
    return (x, cache) if collect_cache else x


def decode_step(params, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                pos: int, cfg: ModelConfig):
    """One decoder token x [B, 1, d_model] at position ``pos`` -> (the
    dec_norm'd hidden state, cache); the self keys and values are written
    in place, the cross ones read."""
    acfg = attn_config(cfg)
    for l, lp in enumerate(unstack(params["decoder"])):
        a = rmsnorm_apply(lp["ln1"], x, cfg.norm_eps)
        a, _, _ = attn_mod.decode_attention(lp["self_attn"], a,
                                            cache["k"][l], cache["v"][l],
                                            pos, acfg)
        x = x + a
        c = rmsnorm_apply(lp["ln_x"], x, cfg.norm_eps)
        c = attn_mod.cross_attention(lp["cross_attn"], c,
                                     (cache["ck"][l], cache["cv"][l]), acfg)
        x = x + c
        m = rmsnorm_apply(lp["ln2"], x, cfg.norm_eps)
        x = x + mlp_apply(lp["mlp"], m, act=cfg.act)
    return rmsnorm_apply(params["dec_norm"], x, cfg.norm_eps), cache


def encdec_cache_specs(cfg: ModelConfig, batch: int, seq: int):
    """The reference's cache specs: ``k``/``v`` of ``seq`` positions,
    ``ck``/``cv`` of ``cfg.encoder_frames``."""
    dt = cfg.compute_dtype
    kvshape = (batch, seq, cfg.num_kv_heads, cfg.head_dim)
    xshape = (batch, cfg.encoder_frames, cfg.num_kv_heads, cfg.head_dim)
    lay = ("batch", "seq", "kv_heads", "head_dim")
    layer = {
        "k": ParamSpec(kvshape, lay, dtype=dt, init="zeros"),
        "v": ParamSpec(kvshape, lay, dtype=dt, init="zeros"),
        "ck": ParamSpec(xshape, lay, dtype=dt, init="zeros"),
        "cv": ParamSpec(xshape, lay, dtype=dt, init="zeros"),
    }
    return stack_specs(layer, cfg.num_layers)
