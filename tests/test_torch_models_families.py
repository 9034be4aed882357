"""repro_torch's MoE, SSM and hybrid decoders against the JAX package's,
on the CPU, on the smoke configs of deepseek-moe-16b, dbrx-132b,
mamba2-370m and jamba-v0.1-52b, with the reference's weights carried
into the port by ``params_from_jax``: prefill logits and every cache
entry (KV and SSM), two decode steps from the reference's own cache
(``cache_from_jax``), greedy generate, and the port's own prefill/decode
consistency. The specs of every full config count the reference's
parameters, bytes and active parameters (no allocation).

Tolerances: f32 atol = rtol = 1e-4. bf16: test_torch_models.BF16_TOL
(atol 0.25, rtol 0.02) for logits, KV and conv tails, where the largest
error seen on these configs was 0.15. mamba2's logits (tied, up to 39;
48 mamba layers in full, 4 here, with no attention to damp the
differences) at MAMBA_BF16_TOL, about twice the largest error seen
there (0.53, two to eight bf16 steps). The SSM state ``h`` at
STATE_BF16_TOL, twice the largest error seen (0.625 on jamba's states of
up to 13.5, ten bf16 steps there: the state sums every token's update,
each from inputs that the two packages round differently in bf16).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import model as JM
from repro.models.params import param_bytes as jparam_bytes
from repro.models.params import param_count as jparam_count
from repro.serve.serve_step import _grow_cache
from repro.serve.serve_step import generate as jgenerate
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import model as M
from repro_torch.models import params as P
from repro_torch.models.convert import cache_from_jax
from repro_torch.serve.serve_step import generate
from test_torch_models import (B, BF16_TOL, F32_TOL, S, _close, _jdecode,
                               _jprefill, _models, _tokens)

MAMBA_BF16_TOL = dict(atol=1.0, rtol=0.02)
STATE_BF16_TOL = dict(atol=1.25, rtol=0.02)
FAMILIES = ["deepseek-moe-16b", "dbrx-132b", "mamba2-370m",
            "jamba-v0.1-52b"]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _entry_tol(name, tol):
    return STATE_BF16_TOL if name == "h" and tol is BF16_TOL else tol


def _next(logits):
    return np.asarray(jnp.argmax(logits[:, -1], axis=-1))[:, None].astype(
        np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_and_decode_match_reference(arch, dtype):
    """Prefill logits and every cache entry, then two decode steps from
    the reference's cache carried over by cache_from_jax."""
    jcfg, jp, cfg, model = _models(arch, dtype)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    logit_tol = MAMBA_BF16_TOL if (tol is BF16_TOL
                                   and arch == "mamba2-370m") else tol
    toks = _tokens(cfg)
    jl, jc = _jprefill(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    tl, tc = M.prefill(model, {"tokens": torch.as_tensor(toks)}, cfg)
    _close(tl, jl, logit_tol)
    assert set(tc["blocks"]) == set(jc["blocks"])
    for key, e in jc["blocks"].items():
        assert set(tc["blocks"][key]) == set(e)
        for name, want in e.items():
            got = tc["blocks"][key][name]
            assert got.dtype == getattr(torch, dtype)
            assert tuple(got.shape) == want.shape
            _close(got, want, _entry_tol(name, tol))
    if "first_layer" in jc:
        _close(tc["first_layer"]["k"], jc["first_layer"]["k"], tol)
    jc = _grow_cache(jc, S + 2)
    tc = cache_from_jax(_np_tree(jc), cfg, "cpu")
    nxt = _next(jl)
    for pos in (S, S + 1):
        jl, jc = _jdecode(jp, jnp.asarray(nxt), jc, jnp.int32(pos), jcfg)
        tl, tc = M.decode_step(model, torch.as_tensor(nxt), tc, pos, cfg)
        _close(tl, jl, logit_tol)
        nxt = _next(jl)
    for key, e in jc["blocks"].items():  # the decoded state too
        for name, want in e.items():
            _close(tc["blocks"][key][name], want, _entry_tol(name, tol))


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_decode_consistency(arch):
    """Decoding token S-1 from a prefill of S-1 tokens gives the logits of
    a prefill of all S at its last position (the port alone, f32; the
    capacity factor at 8.0 so that neither path drops a copy, as the
    reference's own test sets it)."""
    _, _, cfg, model = _models(arch)
    if cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=cfg.moe._replace(capacity_factor=8.0))
    toks = torch.as_tensor(_tokens(cfg))
    full, _ = M.prefill(model, {"tokens": toks}, cfg)
    _, cache = M.prefill(model, {"tokens": toks[:, :S - 1]}, cfg,
                         capacity=S)
    lg, _ = M.decode_step(model, toks[:, S - 1:], cache, S - 1, cfg)
    torch.testing.assert_close(lg, full, **F32_TOL)


@pytest.mark.parametrize("arch", ["mamba2-370m", "deepseek-moe-16b"])
def test_greedy_generate_equals_reference(arch):
    jcfg, jp, cfg, model = _models(arch)
    prompt = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (3, 6)).astype(np.int32)
    want, _ = jgenerate(jp, jcfg, jnp.asarray(prompt), 8)
    got, aux = generate(model, cfg, prompt, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    entry = aux["cache"]["blocks"]["sub0"]
    if arch == "mamba2-370m":  # the state has no sequence axis
        assert set(entry) == {"conv_x", "conv_B", "conv_C", "h"}
        assert entry["h"].shape == (cfg.num_blocks, 3, cfg.ssm.n_heads,
                                    cfg.ssm.d_state, cfg.ssm.head_dim)
    else:
        assert entry["k"].shape[2] == 6 + 8


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_active_counts_equal_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    specs, jspecs = M.model_specs(cfg), JM.model_specs(jcfg)
    assert P.param_count(specs) == jparam_count(jspecs)
    assert P.param_bytes(specs) == jparam_bytes(jspecs)
    assert cfg.active_param_count() == jcfg.active_param_count()
    if arch == "deepseek-moe-16b":
        assert (P.param_count(specs), P.param_bytes(specs),
                cfg.active_param_count()) == (
            16_375_728_128, 32_758_767_616, 2_828_650_496)


@pytest.mark.parametrize("arch", ["mamba2-370m", "jamba-v0.1-52b"])
def test_cache_from_jax_converts_ssm_caches(arch):
    """A stack whose sub0 is a mamba layer: the batch comes from any entry,
    the capacity from the first attention entry (jamba's sub4), none for
    mamba2; every leaf is checked against its spec."""
    jcfg, jp, cfg, _ = _models(arch)
    _, jc = _jprefill(jp, {"tokens": jnp.asarray(_tokens(cfg))}, jcfg)
    jc = _np_tree(_grow_cache(jc, S + 3))
    tc = cache_from_jax(jc, cfg, "cpu")
    for key, e in jc["blocks"].items():
        for name, want in e.items():
            np.testing.assert_array_equal(tc["blocks"][key][name].numpy(),
                                          want)
    if arch == "jamba-v0.1-52b":
        assert tc["blocks"]["sub4"]["k"].shape[2] == S + 3
    h = jc["blocks"]["sub0"]["h"]
    bad = jax.tree_util.tree_map(lambda a: a, jc)
    bad["blocks"]["sub0"]["h"] = h[:, :, :-1]
    with pytest.raises(ValueError, match="sub0.h"):
        cache_from_jax(bad, cfg, "cpu")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_init_scales_in_place_bit_identically(dtype):
    """The in-place scale draws what ``(randn * std).to(dtype)`` draws from
    the same seed (gemma's seed 20 keeps its weights)."""
    spec = P.ParamSpec((96, 40), ("fsdp", "mlp"), dtype=dtype,
                       init="scaled", fan_in_axes=(0,))
    got = P._init_one(spec, torch.Generator().manual_seed(20),
                      torch.device("cpu"))
    want = (torch.randn((96, 40), generator=torch.Generator().manual_seed(20))
            * (1.0 / 96 ** 0.5)).to(dtype)
    assert got.dtype == dtype and torch.equal(got, want)


def test_hybrid_cache_is_laid_out_by_kind():
    """jamba's block: 7 mamba entries without a sequence axis and one KV
    entry at index 4 with the capacity."""
    cfg = dataclasses.replace(get_config("jamba-v0.1-52b"), d_model=64,
                              num_heads=4, num_kv_heads=2, head_dim=16,
                              ssm=get_config("jamba-v0.1-52b").ssm._replace(
                                  d_model=64, head_dim=16))
    cache = M.alloc_cache(cfg, 3, 40, "cpu")["blocks"]
    assert set(cache["sub4"]) == {"k", "v"}
    assert cache["sub4"]["k"].shape == (cfg.num_blocks, 3, 40, 2, 16)
    for i in (0, 1, 2, 3, 5, 6, 7):
        shapes = {n: tuple(t.shape) for n, t in cache[f"sub{i}"].items()}
        assert shapes == {"conv_x": (4, 3, 3, 128), "conv_B": (4, 3, 3, 16),
                          "conv_C": (4, 3, 3, 16), "h": (4, 3, 8, 16, 16)}
    specs = M.decode_cache_specs(cfg, 3, 40)["blocks"]
    assert {k: {n: s.shape for n, s in v.items()} for k, v in specs.items()
            } == {k: {n: tuple(t.shape) for n, t in v.items()}
                  for k, v in cache.items()}
