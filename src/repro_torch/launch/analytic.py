"""Analytic FLOP / HBM-byte models per (arch x shape) — roofline inputs.

The port's copy of ``src/repro/launch/analytic.py``, over the port's
configs; every number equals the reference's.

WHY ANALYTIC: the dry run (``launch/dryrun.py``) runs the real entry
point eagerly on ``meta`` tensors, and ``FlopCounterMode`` counts what
that run executes: the matmuls of the path the port takes (dense
attention over masked entries, every expert at capacity, the SSD's f32
products) and nothing else. What the algorithm needs is still the
roofline's numerator (the least time the chip could take for the work),
so the compute and memory terms come from this explicit arithmetic
model, the same accounting used for MFU; the counted number stays in the
report beside it.

Conventions:
* one matmul [m,k]x[k,n] = 2mkn flops
* train multiplier on block compute: fwd(1) + bwd(2) (+1 remat refwd
  under nothing_saveable)
* causal global attention scores/AV count S_ctx/2 average context;
  sliding-window layers count min(window, S) context
* MoE counts top_k routed + shared experts (ideal, no capacity padding)
"""

from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import LayerDesc, ModelConfig, ShapeSpec


def _attn_flops(cfg: ModelConfig, t: int, ctx: float) -> float:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
        cfg.head_dim
    proj = 2 * t * d * (2 * h * hd + 2 * kv * hd)  # q,o + k,v
    scores_av = 2 * 2 * t * ctx * h * hd
    return proj + scores_av


def _mlp_flops(cfg: ModelConfig, t: int, d_ff: int) -> float:
    return 2 * 3 * t * cfg.d_model * d_ff


def _moe_flops(cfg: ModelConfig, t: int) -> float:
    m = cfg.moe
    router = 2 * t * cfg.d_model * m.num_experts
    routed = m.top_k * _mlp_flops(cfg, t, m.d_ff_expert)
    shared = _mlp_flops(cfg, t, m.num_shared * m.d_ff_expert) \
        if m.num_shared else 0.0
    return router + routed + shared


def _ssd_flops(cfg: ModelConfig, t: int) -> float:
    s = cfg.ssm
    d, di, n, h, p = (s.d_model, s.d_inner, s.d_state, s.n_heads,
                      s.head_dim)
    q = s.chunk
    proj = 2 * t * d * (2 * di + 2 * s.n_groups * n + h) \
        + 2 * t * di * d
    conv = 2 * t * (di + 2 * s.n_groups * n) * s.d_conv
    intra = 2 * t * q * h * (n + p)      # scores + att.x
    states = 3 * 2 * t * h * n * p       # states, y_inter, decode-ish
    return proj + conv + intra + states


def _layer_flops(cfg: ModelConfig, desc: LayerDesc, t: int,
                 ctx: float, d_ff_override: int = 0) -> float:
    total = 0.0
    if desc.kind == "attn":
        total += _attn_flops(cfg, t, ctx)
    else:
        total += _ssd_flops(cfg, t)
    if desc.ff == "dense":
        total += _mlp_flops(cfg, t, d_ff_override or cfg.d_ff)
    elif desc.ff == "moe":
        total += _moe_flops(cfg, t)
    return total


def _ctx_for(cfg: ModelConfig, desc: LayerDesc, shape: ShapeSpec) -> float:
    s = shape.seq
    if shape.kind == "decode":
        full = float(s)
        # baseline decode scans the full (masked) cache even for local
        # layers; the ring cache bounds executed work to the window
        if desc.kind == "attn" and desc.attn_type == "local" \
                and cfg.local_ring_cache:
            return min(float(cfg.local_window), full)
        return full
    full = s / 2.0  # causal average
    if desc.kind == "attn" and desc.attn_type == "local":
        return min(float(cfg.local_window), full)
    return full


def flops_model(cfg: ModelConfig, shape: ShapeSpec, *,
                grad_accum: int = 1, remat: bool = True
                ) -> Dict[str, float]:
    b, s = shape.batch, shape.seq
    t = b * (1 if shape.kind == "decode" else s)

    # blocks
    block = 0.0
    for desc in cfg.pattern:
        block += _layer_flops(cfg, desc, t, _ctx_for(cfg, desc, shape))
    block *= cfg.num_blocks
    if cfg.dense_first_layer:
        block += _layer_flops(
            cfg, LayerDesc(kind="attn", ff="dense"), t,
            _ctx_for(cfg, LayerDesc(), shape), cfg.dense_first_d_ff)
    if cfg.is_encdec:
        tf = b * cfg.encoder_frames
        enc = cfg.encoder_layers * (
            _attn_flops(cfg, tf, cfg.encoder_frames)
            + _mlp_flops(cfg, tf, cfg.d_ff))
        cross = cfg.num_layers * _attn_flops(cfg, t, cfg.encoder_frames)
        block += enc + cross

    logits = 2 * t * cfg.d_model * cfg.vocab_size

    if shape.kind == "train":
        mult = 3.0 + (1.0 if remat else 0.0)
        total = block * mult + logits * 3.0
    else:
        total = block + logits
    return {
        "flops_global": total,
        "flops_block_fwd": block,
        "flops_logits_fwd": logits,
    }


# ---------------------------------------------------------------------------
# HBM bytes (per step, global; divide by chips for per-device)
# ---------------------------------------------------------------------------

def bytes_model(cfg: ModelConfig, shape: ShapeSpec, *,
                param_count: int, grad_accum: int = 1,
                opt_bytes_per_param: int = 8, remat: bool = True
                ) -> Dict[str, float]:
    b, s = shape.batch, shape.seq
    pbytes = 2.0 * param_count  # bf16 weights
    d = cfg.d_model

    if shape.kind == "train":
        a = max(1, grad_accum)
        micro_t = b * s / a
        # weights: read per microbatch fwd + bwd (+ remat refwd)
        w_traffic = pbytes * a * (2.0 + (1.0 if remat else 0.0))
        # grads: f32 accumulate read+write per microbatch + opt read
        g_traffic = 4.0 * param_count * (2.0 * a + 1.0)
        # optimizer: m, v read+write, params read+write (f32 math)
        o_traffic = (2.0 * opt_bytes_per_param + 2 * 4.0) * param_count
        # activations: saved carry per block (bf16) written + read
        act = 2.0 * cfg.num_blocks * micro_t * d * 2.0 * a
        # logits fwd+bwd in f32
        logit = 2.0 * b * s * cfg.vocab_size * 2.0
        total = w_traffic + g_traffic + o_traffic + act + logit
    elif shape.kind == "prefill":
        t = b * s
        attn_layers = sum(1 for dd in cfg.pattern if dd.kind == "attn") \
            * cfg.num_blocks + (1 if cfg.dense_first_layer else 0)
        kvb = 2.0 * attn_layers * t * cfg.num_kv_heads \
            * cfg.head_dim * 2.0
        act = 2.0 * cfg.num_blocks * t * d * 2.0
        total = pbytes + kvb + act + 2.0 * t * cfg.vocab_size
    else:  # decode: weights + cache read dominate. A local layer only
        # reads its window IF the ring cache is enabled; the baseline
        # full-capacity cache is scanned (masked) in its entirety.
        cache = 0.0
        for dd in cfg.pattern:
            if dd.kind != "attn":
                continue
            ctx = min(cfg.local_window, s) \
                if (dd.attn_type == "local" and cfg.local_ring_cache) \
                else s
            cache += (2.0 * cfg.num_blocks * b * ctx
                      * cfg.num_kv_heads * cfg.head_dim * 2.0)
        if cfg.dense_first_layer:
            cache += 2.0 * b * s * cfg.num_kv_heads * cfg.head_dim * 2.0
        if cfg.is_encdec:
            cache += 2.0 * cfg.num_layers * b * cfg.encoder_frames \
                * cfg.num_kv_heads * cfg.head_dim * 2.0
        total = pbytes + cache + 2.0 * b * cfg.vocab_size
    return {"bytes_global": total}
