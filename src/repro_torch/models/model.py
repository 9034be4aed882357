"""Model facade for every family: dense, MoE, SSM, hybrid and
encoder-decoder.

The port's copy of ``src/repro/models/model.py``:

* ``model_specs(cfg)``   — the full parameter ParamSpec tree
* ``Model``              — the parameters as modules (reference names)
* ``loss_fn``            — the training forward, cross entropy and the
                           MoE auxiliary loss
* ``prefill``            — full-sequence forward filling a cache
* ``decode_step``        — one-token step against the cache
* ``decode_cache_specs`` — the cache's specs for a batch and a capacity
* ``input_specs``        — the specs of every input of a (config, shape)
                           cell, for the dry runs

An encoder-decoder config's batch carries ``frames`` [B, F, d_model]
beside its tokens; its decoder ends in its own ``dec_norm``, so the
top-level ``final_norm`` is built (the reference's parameter count) and
used nowhere.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch import device as device_mod
from repro_torch.configs.base import LayerDesc, ModelConfig, ShapeSpec

from . import encdec as encdec_mod
from . import transformer as tfm
from .layers import (cross_entropy, embed_apply, embed_specs, logits_apply,
                     rmsnorm_apply, rmsnorm_specs, rounded)
from .params import ParamSpec, Params, initialize
from .sharding_utils import constrain, zeros
from .ssm import ssm_cache_shape

__all__ = ["FIRST_LAYER", "Model", "alloc_cache", "decode_cache_specs",
           "decode_step", "input_specs", "loss_fn", "model_specs", "prefill"]

# deepseek-moe's layer 0: attention with a dense FF of its own width
FIRST_LAYER = LayerDesc(kind="attn", ff="dense")


# ---------------------------------------------------------------------------
# Specs and state
# ---------------------------------------------------------------------------

def model_specs(cfg: ModelConfig) -> Dict[str, Any]:
    specs: Dict[str, Any] = {
        "embed": embed_specs(cfg.vocab_size, cfg.d_model, cfg.param_dtype),
        "final_norm": rmsnorm_specs(cfg.d_model),
    }
    if not cfg.tie_embeddings:
        specs["head"] = {
            "w": ParamSpec((cfg.d_model, cfg.vocab_size),
                           ("fsdp", "vocab"), dtype=cfg.param_dtype,
                           init="scaled", fan_in_axes=(0,))
        }
    if cfg.is_encdec:
        specs["encdec"] = encdec_mod.encdec_specs(cfg)
        return specs
    if cfg.dense_first_layer:
        specs["first_layer"] = tfm.sublayer_specs(
            cfg, FIRST_LAYER, d_ff_override=cfg.dense_first_d_ff or cfg.d_ff)
    specs["blocks"] = tfm.stack_specs(tfm.block_specs(cfg), cfg.num_blocks)
    return specs


def _jax_order(paths) -> List[str]:
    """Dotted paths in the order jax flattens nested dicts: sorted key by
    key at every level."""
    return sorted(paths, key=lambda p: p.split("."))


class Model(Params):
    """The parameters of ``model_specs(cfg)`` as modules, named by the
    reference's pytree paths and in its layout: ``embed.embedding``,
    ``final_norm.scale``, ``head.w``, ``first_layer.*``, and the stacked
    ``[L, ...]`` leaves of ``blocks`` (or ``encdec.encoder`` and
    ``encdec.decoder``) whole. The forward takes layer l's slices of
    them (``params.unstack``) as it runs."""

    def __init__(self, cfg: ModelConfig, tree):
        super().__init__(tree)
        self.cfg = cfg

    @classmethod
    def init(cls, cfg: ModelConfig, seed: int = 0,
             device=device_mod.DEFAULT) -> "Model":
        """Random weights by the reference's init rules, drawn on
        ``device`` from a generator seeded with ``seed``."""
        return cls(cfg, initialize(model_specs(cfg), seed, device))

    @property
    def device(self) -> torch.device:
        return self.embed.embedding.device

    def reference_leaves(self) -> Dict[str, torch.nn.Parameter]:
        """Dotted reference path -> parameter, in the reference's leaf
        order. The tensors are the model's storage, not copies."""
        flat = dict(self.named_parameters())
        return {k: flat[k] for k in _jax_order(flat)}


def _embed(params, tokens, cfg: ModelConfig):
    x = embed_apply(params["embed"], tokens, cfg.compute_dtype)
    if cfg.embed_scale:
        x = x * rounded(cfg.d_model ** 0.5, cfg.compute_dtype)
    return x


def _logits(params, x, cfg: ModelConfig):
    return logits_apply(
        params["embed"], x, tied=cfg.tie_embeddings,
        head_params=params.get("head"),
        final_softcap=cfg.final_logit_softcap,
    )


def _backbone(params, tokens: torch.Tensor, cfg: ModelConfig, cache=None
              ) -> Tuple[torch.Tensor, Any]:
    """tokens [B, S] -> (the final-normed hidden states [B, S, d_model],
    the MoE loss: the dense first layer's plus the blocks', 0.0 without
    MoE layers); with ``cache`` (from :func:`alloc_cache`) every
    attention layer's keys and values are written at [:, :S], every
    mamba layer's conv tails and state, and no MoE loss is computed."""
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x = _embed(params, tokens, cfg)
    moe0 = 0.0
    if cfg.dense_first_layer:
        x, moe0 = tfm._apply_sublayer(
            params["first_layer"], x, FIRST_LAYER, cfg, positions,
            None if cache is None else cache["first_layer"])
    x, moe_loss = tfm.run_blocks(params["blocks"], x, cfg, positions,
                                 None if cache is None else cache["blocks"])
    return (rmsnorm_apply(params["final_norm"], x, cfg.norm_eps),
            moe0 + moe_loss)


# ---------------------------------------------------------------------------
# Train forward
# ---------------------------------------------------------------------------

def loss_fn(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """batch: tokens and labels [B, S] (an optional mask; frames [B, F,
    d_model] for an encoder-decoder) -> (the cross entropy plus the MoE
    loss, metrics: loss, ntokens, ppl_proxy, moe_loss, total_loss)."""
    if cfg.is_encdec:
        enc_out = encdec_mod.encode(params["encdec"], batch["frames"], cfg)
        x = _embed(params, batch["tokens"], cfg)
        x = encdec_mod.decode_train(params["encdec"], enc_out, x, cfg)
        moe_loss = 0.0
    else:
        x, moe_loss = _backbone(params, batch["tokens"], cfg)
    # on a mesh the label gather cannot run over a vocab-sharded dim
    # (DTensor's masked partial of the picked logit does not combine with
    # the log-sum-exp): the logits are gathered over 'model' first
    logits = constrain(_logits(params, x, cfg), "batch", None, None)
    loss, metrics = cross_entropy(logits, batch["labels"], batch.get("mask"))
    total = loss + moe_loss
    moe_loss = torch.as_tensor(moe_loss, dtype=torch.float32,
                               device=loss.device)
    metrics["moe_loss"] = moe_loss
    metrics["total_loss"] = total
    return total, metrics


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def alloc_cache(cfg: ModelConfig, batch: int, capacity: int, device,
                frames: Optional[int] = None):
    """A zeroed cache in the compute dtype, each sub-layer's entry by its
    kind: KV of ``capacity`` positions for attention (ring layers too, as
    the reference's generate pads every KV cache to one capacity), conv
    tails and state for mamba, which have no sequence axis. An
    encoder-decoder's cache holds cross keys and values of ``frames``
    positions (``cfg.encoder_frames`` by default) beside its self KV."""
    if cfg.is_encdec:
        return encdec_mod.alloc_cache(cfg, batch, capacity,
                                      frames or cfg.encoder_frames, device)

    def entry(desc: LayerDesc, lead=()):
        # the cache's specs (tfm.sublayer_cache_spec) for their logical
        # names: on a mesh each rank allocates its shard
        specs = tfm.sublayer_cache_spec(cfg, desc, batch, capacity)
        if desc.kind == "attn":
            shape = (batch, capacity, cfg.num_kv_heads, cfg.head_dim)
            shapes = {"k": shape, "v": shape}
        else:
            shapes = ssm_cache_shape(cfg.ssm, batch)
        names = ("layers",) if lead else ()
        return {n: zeros(lead + shape, names + specs[n].logical,
                         cfg.compute_dtype, device)
                for n, shape in shapes.items()}

    cache = {"blocks": {f"sub{i}": entry(d, (cfg.num_blocks,))
                        for i, d in enumerate(cfg.pattern)}}
    if cfg.dense_first_layer:
        cache["first_layer"] = entry(FIRST_LAYER)
    return cache


def prefill(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            capacity: Optional[int] = None) -> Tuple[torch.Tensor, Any]:
    """tokens [B, S] (and frames [B, F, d_model] for an encoder-decoder)
    -> (last-position logits [B, 1, V], cache). The KV entries hold
    ``capacity`` positions (S by default, the reference's extent), the
    prompt's keys and values at [:S]; cross keys and values hold the F
    frames given, whatever ``cfg.encoder_frames`` says."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    if cfg.is_encdec:
        enc_out = encdec_mod.encode(params["encdec"], batch["frames"], cfg)
        x = _embed(params, tokens, cfg)
        x, cache = encdec_mod.decode_train(params["encdec"], enc_out, x, cfg,
                                           collect_cache=True,
                                           capacity=capacity or s)
        return _logits(params, x[:, -1:, :], cfg), cache
    cache = alloc_cache(cfg, b, capacity or s, tokens.device)
    x, _ = _backbone(params, tokens, cfg, cache)
    return _logits(params, x[:, -1:, :], cfg), cache


def decode_step(params, tokens: torch.Tensor, cache, pos: int,
                cfg: ModelConfig) -> Tuple[torch.Tensor, Any]:
    """tokens [B, 1] at position ``pos`` -> (logits [B, 1, V], cache);
    the cache is updated in place. An encoder-decoder's decoder ends in
    its dec_norm, not final_norm, as the reference's."""
    x = _embed(params, tokens, cfg)
    if cfg.is_encdec:
        x, cache = encdec_mod.decode_step(params["encdec"], x, cache, pos,
                                          cfg)
        return _logits(params, x, cfg), cache
    if cfg.dense_first_layer:
        x = tfm._sublayer_decode(params["first_layer"], x, FIRST_LAYER, cfg,
                                 cache["first_layer"], pos)
    x = tfm.decode_blocks(params["blocks"], x, cfg, cache["blocks"], pos)
    x = rmsnorm_apply(params["final_norm"], x, cfg.norm_eps)
    return _logits(params, x, cfg), cache


def decode_cache_specs(cfg: ModelConfig, batch: int, seq: int):
    if cfg.is_encdec:
        return encdec_mod.encdec_cache_specs(cfg, batch, seq)
    cache = {"blocks": tfm.cache_specs(cfg, batch, seq)}
    if cfg.dense_first_layer:
        cache["first_layer"] = tfm.sublayer_cache_spec(cfg, FIRST_LAYER,
                                                       batch, seq)
    return cache


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """ParamSpec tree of every model input for (cfg, shape), the
    reference's: tokens and labels [B, S] for train, tokens for prefill
    (with frames [B, F, d_model] for an encoder-decoder), and for decode
    tokens [B, 1], the cache at capacity S and ``pos``. The port's
    :func:`decode_step` takes ``pos`` as a Python int; its spec stays in
    the tree, and the dry run passes ``shape.seq - 1``.

    ``params.abstract`` turns it into ``meta`` tensors,
    ``params.initialize`` into real ones."""
    b, s = shape.batch, shape.seq

    def tok(shp):
        return ParamSpec(shp, ("batch", "seq"), dtype=torch.int32,
                         init="zeros")

    def frames():
        return ParamSpec((b, cfg.encoder_frames, cfg.d_model),
                         ("batch", "seq", "embed"), dtype=cfg.compute_dtype,
                         init="normal", scale=1.0)

    if shape.kind in ("train", "prefill"):
        specs = {"tokens": tok((b, s))}
        if shape.kind == "train":
            specs["labels"] = tok((b, s))
        if cfg.is_encdec:
            specs["frames"] = frames()
        return specs
    if shape.kind == "decode":
        return {
            "tokens": tok((b, 1)),
            "cache": decode_cache_specs(cfg, b, s),
            "pos": ParamSpec((), (), dtype=torch.int32, init="zeros"),
        }
    raise ValueError(shape.kind)
