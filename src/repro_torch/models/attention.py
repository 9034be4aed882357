"""Grouped-query attention with local/global variants, softcap, KV cache.

The port's copy of ``src/repro/models/attention.py``. Three paths,
numerically equivalent where they overlap:

* ``_attend_dense``     — one masked block (short sequences, smoke tests).
* ``_attend_blockwise`` — query-chunked attention: one [chunk, keys]
                          score block live at a time; a sliding-window
                          layer attends a KV slice of width window+chunk.
* ``decode_attention``  — one new token against a KV cache.

``cross_attention`` (decoder to encoder, the encoder-decoder family) is
always the dense path over the encoder's keys: no RoPE, no causal mask,
no window, whatever the decoder's length.

GQA never materializes repeated KV heads: scores come from the grouped
einsum ``[B,Sq,Kv,G,D] x [B,Sk,Kv,D] -> [B,Kv,G,Sq,Sk]`` in f32 (the
reference's ``preferred_element_type``: the operands are widened to f32,
whose products of bf16 values are exact). The path is chosen by the
reference's rule, since the paths round differently.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from .layers import rope, rounded, softcap
from .params import ParamSpec
from .sharding_utils import (constrain, einsum, is_dtensor, unshard_fsdp,
                             viewable)

__all__ = ["NEG_INF", "AttnConfig", "attn_specs", "cross_attention",
           "cross_kv", "decode_attention", "self_attention"]

NEG_INF = -2.3819763e38  # large negative, safe in bf16 after cast


class AttnConfig(NamedTuple):
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    logit_cap: Optional[float] = None
    query_scale: Optional[float] = None  # default 1/sqrt(head_dim)
    rope_theta: float = 10000.0
    use_rope: bool = True
    chunk_q: int = 512  # blockwise query chunk
    dense_threshold: int = 2048  # up to this seq len use the dense path


def attn_specs(cfg: AttnConfig, dtype) -> Dict[str, ParamSpec]:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    specs: Dict[str, ParamSpec] = {
        "wq": ParamSpec((d, h, hd), ("fsdp", "heads", "head_dim"),
                        dtype=dtype, init="scaled", fan_in_axes=(0,)),
        "wk": ParamSpec((d, kv, hd), ("fsdp", "kv_heads", "head_dim"),
                        dtype=dtype, init="scaled", fan_in_axes=(0,)),
        "wv": ParamSpec((d, kv, hd), ("fsdp", "kv_heads", "head_dim"),
                        dtype=dtype, init="scaled", fan_in_axes=(0,)),
        "wo": ParamSpec((h, hd, d), ("heads", "head_dim", "fsdp"),
                        dtype=dtype, init="scaled", fan_in_axes=(0, 1)),
    }
    if cfg.qkv_bias:
        specs["bq"] = ParamSpec((h, hd), ("heads", "head_dim"), dtype=dtype,
                                init="zeros")
        specs["bk"] = ParamSpec((kv, hd), ("kv_heads", "head_dim"),
                                dtype=dtype, init="zeros")
        specs["bv"] = ParamSpec((kv, hd), ("kv_heads", "head_dim"),
                                dtype=dtype, init="zeros")
    return specs


def _proj(x, w, heads: str = "heads"):
    """einsum('bsd,dhk->bshk') as one matmul, the weight's fsdp dim
    gathered first (its ``heads`` dim, 'heads' or 'kv_heads', kept). On a
    mesh the einsum runs on the shards (``sharding_utils.einsum``): the
    matmul's flattened (h, k) would be a strided shard where head_dim is
    split."""
    d, h, k = w.shape
    w = unshard_fsdp(w, "fsdp", heads, "head_dim")
    if is_dtensor(w):
        return einsum("bsd,dhk->bshk", x, w.to(x.dtype))
    return torch.matmul(x, w.to(x.dtype).reshape(d, h * k)).unflatten(
        -1, (h, k))


def _project_qkv(params, x, cfg: AttnConfig, positions):
    dtype = x.dtype
    q = _proj(x, params["wq"])
    k = _proj(x, params["wk"], "kv_heads")
    v = _proj(x, params["wv"], "kv_heads")
    if cfg.qkv_bias:
        q = q + params["bq"].to(dtype)
        k = k + params["bk"].to(dtype)
        v = v + params["bv"].to(dtype)
    if cfg.use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    # after RoPE, in the compute dtype
    q = q * rounded(cfg.query_scale or (cfg.head_dim ** -0.5), dtype)
    # head-parallel attention: Q over 'model'; K/V shard kv_heads when
    # divisible, else replicate over 'model'
    q = constrain(q, "batch", None, "heads", None)
    k = constrain(k, "batch", None, "kv_heads", None)
    v = constrain(v, "batch", None, "kv_heads", None)
    return q, k, v


def _group_q(q: torch.Tensor, num_kv: int) -> torch.Tensor:
    """[B,S,H,D] -> [B,S,Kv,G,D]; on a mesh whose heads split does not
    divide the kv heads, the heads are gathered first
    (``sharding_utils.viewable``)."""
    b, s, h, d = q.shape
    return viewable(q, 2, num_kv).reshape(b, s, num_kv, h // num_kv, d)


def _scores(q5, k):
    # q5: [B,Sq,Kv,G,D], k: [B,Sk,Kv,D] -> [B,Kv,G,Sq,Sk]  (f32)
    return einsum("bqkgd,bskd->bkgqs", q5.float(), k.float())


def _weighted(p, v):
    # p: [B,Kv,G,Sq,Sk] f32 -> the value dtype, v: [B,Sk,Kv,D]
    return einsum("bkgqs,bskd->bqkgd", p.to(v.dtype), v)


def _attend_dense(q, k, v, *, causal: bool, window: Optional[int],
                  logit_cap: Optional[float], q_positions, k_positions
                  ) -> torch.Tensor:
    b, sq, h, d = q.shape
    kv = k.shape[2]
    s = _scores(_group_q(q, kv), k)  # [B,Kv,G,Sq,Sk] f32
    s = softcap(s, logit_cap) if logit_cap else s
    mask = torch.ones((sq, k.shape[1]), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_positions[:, None] >= k_positions[None, :]
    if window is not None:
        mask &= q_positions[:, None] - k_positions[None, :] < window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s.float(), dim=-1)
    return _weighted(p, v).reshape(b, sq, h, d)


def _attend_blockwise(q, k, v, *, causal: bool, window: Optional[int],
                      logit_cap: Optional[float], chunk_q: int
                      ) -> torch.Tensor:
    """Attention one query chunk at a time.

    Global-causal: each chunk attends over the full (masked) key range, one
    [chunk, Sk] score block live at a time. Sliding-window: each chunk
    attends a KV slice of width window+chunk of the keys padded on the
    left by window, so its compute is O(S * (window + chunk))."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    if sq % chunk_q:
        raise ValueError(f"sequence {sq} is not a multiple of the chunk "
                         f"{chunk_q}")
    dev = q.device
    local = window is not None and (window + chunk_q) < sk
    if local:
        span = window + chunk_q  # static slice width
        pad = span - chunk_q
        kp = torch.nn.functional.pad(k, (0, 0, 0, 0, pad, 0))
        vp = torch.nn.functional.pad(v, (0, 0, 0, 0, pad, 0))
    chunks = []
    for ci in range(sq // chunk_q):
        qi = q[:, ci * chunk_q:(ci + 1) * chunk_q]
        q_pos = ci * chunk_q + torch.arange(chunk_q, device=dev)
        if local:
            start = ci * chunk_q  # in padded coordinates
            ks = kp[:, start:start + span]
            vs = vp[:, start:start + span]
            k_pos = start - pad + torch.arange(span, device=dev)
        else:
            ks, vs = k, v
            k_pos = torch.arange(sk, device=dev)
        s = _scores(_group_q(qi, kvh), ks)
        s = softcap(s, logit_cap) if logit_cap else s
        mask = (k_pos >= 0)[None, :].expand(chunk_q, -1)  # padded region
        if causal:
            mask = mask & (q_pos[:, None] >= k_pos[None, :])
        if window is not None:
            mask = mask & (q_pos[:, None] - k_pos[None, :] < window)
        s = torch.where(mask, s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        chunks.append(_weighted(p, vs).reshape(b, chunk_q, h, d))
    return torch.cat(chunks, dim=1)


def _out_proj(out, wo):
    """einsum('bshk,hkd->bsd') as one matmul, the weight's fsdp dim
    gathered first; on a mesh on the shards, as in :func:`_proj`."""
    h, k, d = wo.shape
    wo = unshard_fsdp(wo, "heads", "head_dim", "fsdp")
    if is_dtensor(wo):
        return einsum("bshk,hkd->bsd", out, wo.to(out.dtype))
    return torch.matmul(out.flatten(-2), wo.to(out.dtype).reshape(h * k, d))


def self_attention(params, x: torch.Tensor, cfg: AttnConfig, *,
                   causal: bool = True, window: Optional[int] = None,
                   positions: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, Tuple[torch.Tensor,
                                                  torch.Tensor]]:
    """Full-sequence self attention (prefill). Returns (output, (k, v)) so
    prefill can fill the cache. Dense when ``s <= dense_threshold`` or
    ``s`` is no multiple of ``chunk_q``, blockwise otherwise."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)
    q, k, v = _project_qkv(params, x, cfg, positions)
    if s <= cfg.dense_threshold or s % cfg.chunk_q != 0:
        out = _attend_dense(q, k, v, causal=causal, window=window,
                            logit_cap=cfg.logit_cap, q_positions=positions,
                            k_positions=positions)
    else:
        out = _attend_blockwise(q, k, v, causal=causal, window=window,
                                logit_cap=cfg.logit_cap, chunk_q=cfg.chunk_q)
    return _out_proj(out, params["wo"]), (k, v)


def cross_attention(params, x: torch.Tensor,
                    enc_kv: Tuple[torch.Tensor, torch.Tensor],
                    cfg: AttnConfig) -> torch.Tensor:
    """Decoder-to-encoder attention: x [B, S, d_model] against the
    precomputed encoder keys and values ([B, F, Kv, D] each). The queries
    get no RoPE, the scale rounded to x's dtype; the dense path, unmasked,
    with the logit cap, at any S."""
    dtype = x.dtype
    q = _proj(x, params["wq"])
    if cfg.qkv_bias:
        q = q + params["bq"].to(dtype)
    q = q * rounded(cfg.query_scale or (cfg.head_dim ** -0.5), dtype)
    k, v = enc_kv
    dev = x.device
    out = _attend_dense(q, k, v, causal=False, window=None,
                        logit_cap=cfg.logit_cap,
                        q_positions=torch.arange(x.shape[1], device=dev),
                        k_positions=torch.arange(k.shape[1], device=dev))
    return _out_proj(out, params["wo"])


def cross_kv(params, enc_out: torch.Tensor, cfg: AttnConfig
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The encoder output [B, F, d_model] -> the cross keys and values
    [B, F, Kv, D], in its dtype, without RoPE."""
    dtype = enc_out.dtype
    k = _proj(enc_out, params["wk"], "kv_heads")
    v = _proj(enc_out, params["wv"], "kv_heads")
    if cfg.qkv_bias:
        k = k + params["bk"].to(dtype)
        v = v + params["bv"].to(dtype)
    return k, v


# ---------------------------------------------------------------------------
# Decode (single token, KV cache)
# ---------------------------------------------------------------------------

def decode_attention(params, x: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, pos: int, cfg: AttnConfig, *,
                     window: Optional[int] = None, ring: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode step: x [B, 1, d_model] against the cache [B, Smax, Kv,
    D], the new token at position ``pos``. Writes the new key and value
    into the cache in place and returns (out, cache_k, cache_v).

    ``ring=True`` (sliding-window layers): the capacity equals the window
    and writes wrap at ``pos % cap``; RoPE is applied before caching
    (absolute positions) and softmax is order-invariant, so only a fill
    mask is needed while pos + 1 < cap. Every slot of the cache is scored
    (the masked ones at NEG_INF), as the reference reads it at capacity."""
    b = x.shape[0]
    dev = x.device
    positions = torch.full((1,), pos, dtype=torch.int32, device=dev)
    q, k_new, v_new = _project_qkv(params, x, cfg, positions)
    smax = cache_k.shape[1]
    write_at = (pos % smax) if ring else pos
    cache_k[:, write_at] = k_new[:, 0].to(cache_k.dtype)
    cache_v[:, write_at] = v_new[:, 0].to(cache_v.dtype)
    s = _scores(_group_q(q, cache_k.shape[2]),
                cache_k.to(x.dtype))  # [B,Kv,G,1,Smax]
    s = softcap(s, cfg.logit_cap) if cfg.logit_cap else s
    k_pos = torch.arange(smax, device=dev)
    mask = k_pos <= pos  # ring: the fill mask; the window is the capacity
    if window is not None and not ring:
        mask &= k_pos > pos - window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = _weighted(p, cache_v.to(x.dtype)).reshape(b, 1, q.shape[2],
                                                  q.shape[3])
    return _out_proj(o, params["wo"]), cache_k, cache_v
