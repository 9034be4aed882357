"""Serving: the decode step and the generate loop.

The port's copy of ``src/repro/serve/serve_step.py``. ``generate`` drives
prefill and then one decode step per new token; the KV cache is allocated
at capacity ``s + n_steps`` up front and prefill writes the prompt's
prefix, which computes what the reference's prefill plus ``_grow_cache``
does without a second copy. Sampling is greedy (the first maximum, as
``jnp.argmax`` and ``torch.argmax`` both take) or temperature-categorical
from a ``torch.Generator``: the reference draws from jax keys, which torch
cannot reproduce, so a sampled run is reproducible from its generator
only. An encoder-decoder takes its frames [B, F, d_model] beside the
prompt; only its self keys and values are allocated at capacity, its
cross keys and values keep the frames' extent. Generation runs where the
parameters live: a model is built on the card unless its caller asks for
the CPU.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as model_mod

__all__ = ["build_decode_step", "generate"]


def _gumbel_max(logits: torch.Tensor, temperature: float,
                g: torch.Generator) -> torch.Tensor:
    """A categorical draw over the last axis of logits / temperature, by
    the Gumbel-max rule (``jax.random.categorical``'s)."""
    z = logits.float() / temperature
    u = torch.rand(z.shape, generator=g, device=z.device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return torch.argmax(z - torch.log(-torch.log(u)), dim=-1)


def build_decode_step(cfg: ModelConfig, *, sample: str = "greedy",
                      temperature: float = 1.0):
    """(params, tokens [B, 1], cache, pos, generator=None) -> (next token
    [B] int32, logits, cache)."""

    def decode_step(params, tokens, cache, pos: int,
                    generator: Optional[torch.Generator] = None):
        logits, cache = model_mod.decode_step(params, tokens, cache, pos,
                                              cfg)
        if sample == "greedy":
            nxt = torch.argmax(logits[:, -1, :], dim=-1)
        else:
            nxt = _gumbel_max(logits[:, -1, :], temperature, generator)
        return nxt.to(torch.int32), logits, cache

    return decode_step


def generate(params, cfg: ModelConfig, prompt, n_steps: int, *,
             sample: str = "greedy",
             generator: Optional[torch.Generator] = None,
             frames=None) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """prompt [B, S] (a tensor or array; moved to the parameters' device)
    -> generated tokens [B, n_steps] int32 on that device, and {"cache"}.
    An encoder-decoder needs ``frames`` [B, F, d_model]. The first token
    is the prefill's argmax, as the reference's. A sampled run draws from
    ``generator`` (one seeded 0 on the device if none)."""
    dev = params.device
    prompt = torch.as_tensor(prompt, device=dev)
    b, s = prompt.shape
    batch = {"tokens": prompt}
    if cfg.is_encdec:
        if frames is None:
            raise ValueError(f"{cfg.name} is an encoder-decoder: generate "
                             "needs its frames")
        batch["frames"] = torch.as_tensor(frames, device=dev)
    logits, cache = model_mod.prefill(params, batch, cfg,
                                      capacity=s + n_steps)
    step_fn = build_decode_step(cfg, sample=sample)
    if sample != "greedy" and generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    tok = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
    toks = [tok]
    for t in range(n_steps - 1):
        tok, _, cache = step_fn(params, tok[:, None], cache, s + t, generator)
        toks.append(tok)
    return torch.stack(toks, dim=1), {"cache": cache}
