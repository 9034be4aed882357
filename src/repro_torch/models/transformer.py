"""Decoder-only transformer assembly: the block stack, prefill, decode.

The port's copy of ``src/repro/models/transformer.py``. Depth is
``num_blocks`` repetitions of the config's layer *pattern* (period P);
layer i's sub-layer is ``pattern[i % P]``: an attention or a mamba mixer,
then a dense, MoE or no FF. The reference stacks one block's parameters
along a leading 'layers' axis and scans over blocks; here the
parameters stay stacked and the scan is a Python loop over block g's
slices of them (``params.unstack``). The cache is stacked too, [G, ...] per
sub-layer (KV for attention, conv tails and state for mamba: jamba's
8-layer block carries 7 mamba entries and 1 KV entry), and is written in
place. Without a cache (training) the forward returns the MoE auxiliary
loss beside the hidden states; with one (serving) it computes none, as
the reference's prefill drops it. In training (no cache, grad enabled) every block is
recomputed in the backward pass (``torch.utils.checkpoint``) whenever
``cfg.remat_policy`` is not ``"none"``: torch has no counterpart of
jax's ``dots`` policies, so every policy recomputes the whole block.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LayerDesc, ModelConfig

from . import attention as attn_mod
from . import moe as moe_mod
from . import ssm as ssm_mod
from .layers import mlp_apply, mlp_specs, rmsnorm_apply, rmsnorm_specs
from .params import ParamSpec, tree_map_specs, unstack
from .sharding_utils import constrain

__all__ = ["attn_config", "block_specs", "cache_specs", "decode_blocks",
           "remat", "run_blocks", "stack_specs", "sublayer_cache_spec",
           "sublayer_specs"]


def attn_config(cfg: ModelConfig) -> attn_mod.AttnConfig:
    return attn_mod.AttnConfig(
        d_model=cfg.d_model,
        num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.head_dim,
        qkv_bias=cfg.qkv_bias,
        logit_cap=cfg.attn_logit_softcap,
        query_scale=cfg.query_scale,
        rope_theta=cfg.rope_theta,
        chunk_q=cfg.attn_chunk_q,
        dense_threshold=cfg.attn_dense_threshold,
    )


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------

def sublayer_specs(cfg: ModelConfig, desc: LayerDesc,
                   d_ff_override: int = 0) -> Dict[str, Any]:
    dt = cfg.param_dtype
    specs: Dict[str, Any] = {"ln1": rmsnorm_specs(cfg.d_model)}
    if desc.kind == "attn":
        specs["attn"] = attn_mod.attn_specs(attn_config(cfg), dt)
    else:
        specs["mamba"] = ssm_mod.ssm_specs(cfg.ssm, dt)
    if cfg.post_norm:
        specs["post_ln1"] = rmsnorm_specs(cfg.d_model)
    if desc.ff != "none":
        specs["ln2"] = rmsnorm_specs(cfg.d_model)
        if desc.ff == "dense":
            specs["mlp"] = mlp_specs(cfg.d_model, d_ff_override or cfg.d_ff,
                                     dt)
        else:
            specs["moe"] = moe_mod.moe_specs(cfg.d_model, cfg.moe, dt)
        if cfg.post_norm:
            specs["post_ln2"] = rmsnorm_specs(cfg.d_model)
    return specs


def block_specs(cfg: ModelConfig) -> Dict[str, Any]:
    return {f"sub{i}": sublayer_specs(cfg, d)
            for i, d in enumerate(cfg.pattern)}


def stack_specs(tree, g: int):
    """Prepend a 'layers' axis of size g to every ParamSpec."""
    return tree_map_specs(
        lambda s: ParamSpec((g,) + s.shape, ("layers",) + s.logical,
                            dtype=s.dtype, init=s.init, scale=s.scale,
                            fan_in_axes=tuple(a + 1 for a in
                                              (s.fan_in_axes or (0,)))),
        tree,
    )


# ---------------------------------------------------------------------------
# Forward (prefill; fills the cache when one is given)
# ---------------------------------------------------------------------------

def _ff(p, h: torch.Tensor, desc: LayerDesc, cfg: ModelConfig
        ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """The FF's output and the MoE layer's aux values (None if dense)."""
    if desc.ff == "dense":
        return mlp_apply(p["mlp"], h, act=cfg.act), None
    return moe_mod.moe_apply(p["moe"], h, cfg.moe, act=cfg.act)


def remat(fn, cfg: ModelConfig):
    """fn recomputed in the backward pass when the config asks for any
    remat policy and a graph is being built through its inputs; fn itself
    otherwise (serving)."""
    if cfg.remat_policy == "none":
        return fn

    def call(*args):
        if torch.is_grad_enabled() and any(a.requires_grad for a in args):
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    return call


def _write(entry: Dict[str, torch.Tensor], new: Dict[str, torch.Tensor]
           ) -> None:
    for name, t in new.items():
        entry[name].copy_(t)


def _sp(cfg: ModelConfig):
    """Residual-stream seq axis under sequence parallelism."""
    return "seq_model" if cfg.sequence_parallel else None


def _apply_sublayer(p, x: torch.Tensor, desc: LayerDesc, cfg: ModelConfig,
                    positions: torch.Tensor,
                    entry: Optional[Dict[str, torch.Tensor]] = None
                    ) -> Tuple[torch.Tensor, Any]:
    """One sub-layer over the whole sequence: (x, its MoE loss; 0.0 for a
    dense or no FF, and with a cache). With ``entry`` (its slot of the
    cache) an attention layer writes its keys and values at [:, :S] of
    {k, v} [B, cap, Kv, D], a mamba layer its conv tails and state.

    Sequence parallelism (cfg.sequence_parallel): the residual stream x
    stays sharded (batch, seq->model); the pre-norm runs local, the
    normed input is gathered over 'model' right before each mixer, and
    the mixer's output is constrained back to seq-sharded, so the
    output projection's partial sums are reduce-scattered instead of
    all-reduced (Korthikanti et al.). Without a mesh every pin is the
    identity."""
    h = rmsnorm_apply(p["ln1"], x, cfg.norm_eps)
    if cfg.sequence_parallel:
        h = constrain(h, "batch", None, None)  # gather seq for the mixer
    if desc.kind == "attn":
        window = cfg.local_window if desc.attn_type == "local" else None
        out, (k, v) = attn_mod.self_attention(
            p["attn"], h, attn_config(cfg), causal=True, window=window,
            positions=positions)
        if entry is not None:
            s = k.shape[1]
            entry["k"][:, :s] = k.to(entry["k"].dtype)
            entry["v"][:, :s] = v.to(entry["v"].dtype)
    else:
        if entry is None:
            out = ssm_mod.ssm_apply(p["mamba"], h, cfg.ssm)
        else:
            out, new = ssm_mod.ssm_apply(p["mamba"], h, cfg.ssm,
                                         return_cache=True)
            _write(entry, new)
    if cfg.sequence_parallel:
        out = constrain(out, "batch", _sp(cfg), None)  # reduce-scatter
    if cfg.post_norm:
        out = rmsnorm_apply(p["post_ln1"], out, cfg.norm_eps)
    x = x + out
    moe_loss = 0.0
    if desc.ff != "none":
        h = rmsnorm_apply(p["ln2"], x, cfg.norm_eps)
        if cfg.sequence_parallel and desc.ff == "dense":
            h = constrain(h, "batch", None, None)
        out, aux = _ff(p, h, desc, cfg)
        if aux is not None and entry is None:
            moe_loss = moe_mod.moe_loss(aux, cfg.moe)
        if cfg.sequence_parallel:
            out = constrain(out, "batch", _sp(cfg), None)
        if cfg.post_norm:
            out = rmsnorm_apply(p["post_ln2"], out, cfg.norm_eps)
        x = x + out
    return x, moe_loss


def _entry(cache, key: str, g: int):
    return None if cache is None else {n: t[g] for n, t in cache[key].items()}


def _block_fwd(bp, x: torch.Tensor, cfg: ModelConfig,
               positions: torch.Tensor, cache, g: int
               ) -> Tuple[torch.Tensor, Any]:
    moe_total = 0.0
    x = constrain(x, "batch", _sp(cfg), None)
    for i, desc in enumerate(cfg.pattern):
        key = f"sub{i}"
        x, ml = _apply_sublayer(bp[key], x, desc, cfg, positions,
                                _entry(cache, key, g))
        moe_total = moe_total + ml
    return x, moe_total


def run_blocks(blocks, x: torch.Tensor, cfg: ModelConfig,
               positions: torch.Tensor, cache=None
               ) -> Tuple[torch.Tensor, Any]:
    """Every block in order: (x, the MoE loss summed over blocks in
    order; 0.0 without MoE layers or with a cache). ``cache`` (the stacked
    cache's 'blocks' part) receives each sub-layer's entry; without one,
    each block is recomputed in the backward pass as ``remat`` decides."""
    moe_total = 0.0
    for g, bp in enumerate(unstack(blocks)):
        if cache is None:
            x, ml = remat(lambda h, bp=bp, g=g: _block_fwd(
                bp, h, cfg, positions, None, g), cfg)(x)
        else:
            x, ml = _block_fwd(bp, x, cfg, positions, cache, g)
        moe_total = moe_total + ml
    return x, moe_total


# ---------------------------------------------------------------------------
# Decode (one token through all blocks, stacked cache)
# ---------------------------------------------------------------------------

def _sublayer_decode(p, x: torch.Tensor, desc: LayerDesc, cfg: ModelConfig,
                     entry: Dict[str, torch.Tensor], pos: int
                     ) -> torch.Tensor:
    h = rmsnorm_apply(p["ln1"], x, cfg.norm_eps)
    if desc.kind == "attn":
        window = cfg.local_window if desc.attn_type == "local" else None
        ring = cfg.local_ring_cache and desc.attn_type == "local"
        out, _, _ = attn_mod.decode_attention(
            p["attn"], h, entry["k"], entry["v"], pos, attn_config(cfg),
            window=window, ring=ring)
    else:
        out, new = ssm_mod.ssm_decode_step(p["mamba"], h, entry, cfg.ssm)
        _write(entry, new)
    if cfg.post_norm:
        out = rmsnorm_apply(p["post_ln1"], out, cfg.norm_eps)
    x = x + out
    if desc.ff != "none":
        out = _ff(p, rmsnorm_apply(p["ln2"], x, cfg.norm_eps), desc, cfg)[0]
        if cfg.post_norm:
            out = rmsnorm_apply(p["post_ln2"], out, cfg.norm_eps)
        x = x + out
    return x


def decode_blocks(blocks, x: torch.Tensor, cfg: ModelConfig, cache,
                  pos: int) -> torch.Tensor:
    """One token through the stack; the cache is updated in place."""
    for g, bp in enumerate(unstack(blocks)):
        for i, desc in enumerate(cfg.pattern):
            key = f"sub{i}"
            x = _sublayer_decode(bp[key], x, desc, cfg, _entry(cache, key, g),
                                 pos)
    return x


# ---------------------------------------------------------------------------
# Cache specs
# ---------------------------------------------------------------------------

def sublayer_cache_spec(cfg: ModelConfig, desc: LayerDesc, batch: int,
                        seq: int) -> Dict[str, Any]:
    if desc.kind == "attn":
        cap = seq
        if cfg.local_ring_cache and desc.attn_type == "local":
            cap = min(seq, cfg.local_window)
        kvshape = (batch, cap, cfg.num_kv_heads, cfg.head_dim)
        logical = ("batch", "seq", "kv_heads", "head_dim")
        return {n: ParamSpec(kvshape, logical, dtype=cfg.compute_dtype,
                             init="zeros") for n in ("k", "v")}
    logical = {"conv_x": ("batch", "conv", "ssm_inner"),
               "conv_B": ("batch", "conv", None),
               "conv_C": ("batch", "conv", None),
               "h": ("batch", "ssm_inner", "ssm_state", None)}
    return {n: ParamSpec(shape, logical[n], dtype=cfg.compute_dtype,
                         init="zeros")
            for n, shape in ssm_mod.ssm_cache_shape(cfg.ssm, batch).items()}


def cache_specs(cfg: ModelConfig, batch: int, seq: int):
    block = {f"sub{i}": sublayer_cache_spec(cfg, d, batch, seq)
             for i, d in enumerate(cfg.pattern)}
    return stack_specs(block, cfg.num_blocks)
