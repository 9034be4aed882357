"""Model facade for the decoder families: dense, MoE, SSM and hybrid.

The port's copy of ``src/repro/models/model.py``:

* ``model_specs(cfg)``   — the full parameter ParamSpec tree
* ``Model``              — the parameters as modules (reference names)
* ``prefill``            — full-sequence forward filling a cache
* ``decode_step``        — one-token step against the cache
* ``decode_cache_specs`` — the cache's specs for a batch and a capacity

An encoder-decoder config raises NotImplementedError: that family waits
for a later slice (ROADMAP Queue 1). The training loss waits for the
training slice.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import device as device_mod
from repro_torch.configs.base import LayerDesc, ModelConfig

from . import transformer as tfm
from .layers import (embed_apply, embed_specs, logits_apply, rmsnorm_apply,
                     rmsnorm_specs, rounded)
from .params import ParamSpec, Params, initialize
from .ssm import ssm_cache_shape

__all__ = ["FIRST_LAYER", "Model", "alloc_cache", "decode_cache_specs",
           "decode_step", "model_specs", "prefill"]

# deepseek-moe's layer 0: attention with a dense FF of its own width
FIRST_LAYER = LayerDesc(kind="attn", ff="dense")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.is_encdec:
        raise tfm.not_ported(f"{cfg.name} is an encoder-decoder")


# ---------------------------------------------------------------------------
# Specs and state
# ---------------------------------------------------------------------------

def model_specs(cfg: ModelConfig) -> Dict[str, Any]:
    _check_family(cfg)
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
    if cfg.dense_first_layer:
        specs["first_layer"] = tfm.sublayer_specs(
            cfg, FIRST_LAYER, d_ff_override=cfg.dense_first_d_ff or cfg.d_ff)
    specs["blocks"] = tfm.stack_specs(tfm.block_specs(cfg), cfg.num_blocks)
    return specs


def _block(tree, g: int):
    return {k: _block(v, g) if isinstance(v, dict) else v[g]
            for k, v in tree.items()}


class Model(Params):
    """The parameters of ``model_specs(cfg)`` as modules, named by the
    reference's pytree paths: ``embed.embedding``, ``final_norm.scale``,
    ``head.w``, ``first_layer.*``, and ``blocks.<g>.sub<i>.*`` for block
    g, which holds slice g of each stacked ``[G, ...]`` leaf (a view: no
    copy)."""

    def __init__(self, cfg: ModelConfig, tree):
        _check_family(cfg)
        tree = dict(tree)
        stacked = tree.pop("blocks")
        super().__init__(tree)
        self.cfg = cfg
        self.blocks = torch.nn.ModuleList(
            Params(_block(stacked, g)) for g in range(cfg.num_blocks))

    @classmethod
    def init(cls, cfg: ModelConfig, seed: int = 0,
             device=device_mod.DEFAULT) -> "Model":
        """Random weights by the reference's init rules, drawn on
        ``device`` from a generator seeded with ``seed``."""
        return cls(cfg, initialize(model_specs(cfg), seed, device))

    @property
    def device(self) -> torch.device:
        return self.embed.embedding.device


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
              ) -> torch.Tensor:
    """tokens [B, S] -> the final-normed hidden states [B, S, d_model];
    with ``cache`` (from :func:`alloc_cache`) every attention layer's keys
    and values are written at [:, :S], every mamba layer's conv tails and
    state."""
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x = _embed(params, tokens, cfg)
    if cfg.dense_first_layer:
        x = tfm._apply_sublayer(
            params["first_layer"], x, FIRST_LAYER, cfg, positions,
            None if cache is None else cache["first_layer"])
    x = tfm.run_blocks(params["blocks"], x, cfg, positions,
                       None if cache is None else cache["blocks"])
    return rmsnorm_apply(params["final_norm"], x, cfg.norm_eps)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def alloc_cache(cfg: ModelConfig, batch: int, capacity: int, device):
    """A zeroed cache in the compute dtype, each sub-layer's entry by its
    kind: KV of ``capacity`` positions for attention (ring layers too, as
    the reference's generate pads every KV cache to one capacity), conv
    tails and state for mamba, which have no sequence axis."""
    def entry(desc: LayerDesc, lead=()):
        if desc.kind == "attn":
            shape = (batch, capacity, cfg.num_kv_heads, cfg.head_dim)
            shapes = {"k": shape, "v": shape}
        else:
            shapes = ssm_cache_shape(cfg.ssm, batch)
        return {n: torch.zeros(lead + shape, dtype=cfg.compute_dtype,
                               device=device) for n, shape in shapes.items()}

    cache = {"blocks": {f"sub{i}": entry(d, (cfg.num_blocks,))
                        for i, d in enumerate(cfg.pattern)}}
    if cfg.dense_first_layer:
        cache["first_layer"] = entry(FIRST_LAYER)
    return cache


def prefill(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            capacity: Optional[int] = None) -> Tuple[torch.Tensor, Any]:
    """tokens [B, S] -> (last-position logits [B, 1, V], cache). The KV
    entries hold ``capacity`` positions (S by default, the reference's
    extent), the prompt's keys and values at [:S]."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    cache = alloc_cache(cfg, b, capacity or s, tokens.device)
    x = _backbone(params, tokens, cfg, cache)
    return _logits(params, x[:, -1:, :], cfg), cache


def decode_step(params, tokens: torch.Tensor, cache, pos: int,
                cfg: ModelConfig) -> Tuple[torch.Tensor, Any]:
    """tokens [B, 1] at position ``pos`` -> (logits [B, 1, V], cache);
    the cache is updated in place."""
    x = _embed(params, tokens, cfg)
    if cfg.dense_first_layer:
        x = tfm._sublayer_decode(params["first_layer"], x, FIRST_LAYER, cfg,
                                 cache["first_layer"], pos)
    x = tfm.decode_blocks(params["blocks"], x, cfg, cache["blocks"], pos)
    x = rmsnorm_apply(params["final_norm"], x, cfg.norm_eps)
    return _logits(params, x, cfg), cache


def decode_cache_specs(cfg: ModelConfig, batch: int, seq: int):
    _check_family(cfg)
    cache = {"blocks": tfm.cache_specs(cfg, batch, seq)}
    if cfg.dense_first_layer:
        cache["first_layer"] = tfm.sublayer_cache_spec(cfg, FIRST_LAYER,
                                                       batch, seq)
    return cache
