"""repro_torch's encoder-decoder (seamless-m4t-medium) against the JAX
package's, on the CPU: cross attention and the cross keys and values on
numpy-seeded inputs, then the smoke config with the reference's weights
carried over by ``params_from_jax``: ``encode``, ``decode_train`` with and
without its cache, ``decode_step`` from the reference's cache,
``model.prefill``/``decode_step`` with frames of another extent than
``cfg.encoder_frames``, greedy ``generate(frames=)``, and
``params_to_numpy`` as the inverse of ``params_from_jax`` for seamless
and one config of each other family.

Tolerances: f32 atol = rtol = 1e-4 (test_torch_models.F32_TOL); bf16 at
BF16_TOL (atol 0.25, rtol 0.02). Measured here: prefill and decode
logits (up to 58) within 0.25 of the reference's, one bf16 step at that
magnitude; the cache entries within 0.031; bf16 against f32 within 0.25.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import attention as JA
from repro.models import encdec as JE
from repro.models import model as JM
from repro.models.params import initialize as jinitialize
from repro.models.transformer import attn_config as jattn_config
from repro.serve.serve_step import generate as jgenerate
from repro_torch.configs import get_config
from repro_torch.models import attention as A
from repro_torch.models import encdec as E
from repro_torch.models import model as M
from repro_torch.models.convert import (cache_from_jax, params_from_jax,
                                        params_to_numpy)
from repro_torch.models.transformer import attn_config
from repro_torch.serve.serve_step import generate
from test_torch_models import (BF16_TOL, F32_TOL, _close, _configs,
                               _jdecode, _jprefill, _models)

ARCH = "seamless-m4t-medium"
B, S, F = 2, 12, 10  # F differs from the smoke config's 16 frames


def _t(x):
    return torch.as_tensor(np.array(x))


def _frames(cfg, b=B, f=F, seed=3):
    return np.random.default_rng(seed).normal(
        size=(b, f, cfg.d_model)).astype(np.float32)


def _toks(cfg, b=B, s=S, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


# ---------------------------------------------------------- cross attention
@pytest.mark.parametrize("bias,cap,scale", [(False, None, None),
                                            (True, 20.0, None),
                                            (False, None, 0.3)])
def test_cross_attention_and_kv_match_reference(bias, cap, scale):
    """No RoPE, the dense path, the logit cap and the query scale; GQA
    with 4 query heads over 2 kv heads."""
    kw = dict(d_model=32, num_heads=4, num_kv_heads=2, head_dim=8,
              qkv_bias=bias, logit_cap=cap, query_scale=scale)
    jcfg, cfg = JA.AttnConfig(**kw), A.AttnConfig(**kw)
    specs = A.attn_specs(cfg, torch.float32)
    r = np.random.default_rng(0)
    p = {k: r.normal(size=s.shape).astype(np.float32) * 0.3
         for k, s in specs.items()}
    x = r.normal(size=(2, 7, 32)).astype(np.float32)
    enc = r.normal(size=(2, 11, 32)).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: _t(v) for k, v in p.items()}
    jk, jv = JA.cross_kv(jp, jnp.asarray(enc), jcfg)
    tk, tv = A.cross_kv(tp, _t(enc), cfg)
    _close(tk, jk)
    _close(tv, jv)
    want = JA.cross_attention(jp, jnp.asarray(x), (jk, jv), jcfg)
    got = A.cross_attention(tp, _t(x), (tk, tv), cfg)
    assert got.shape == (2, 7, 32)
    _close(got, want)


def test_cross_attention_stays_dense_past_the_threshold():
    """A decoder longer than dense_threshold (a multiple of chunk_q) still
    attends the encoder through the dense path, as the reference's."""
    kw = dict(d_model=16, num_heads=2, num_kv_heads=2, head_dim=8,
              chunk_q=8, dense_threshold=16)
    jcfg, cfg = JA.AttnConfig(**kw), A.AttnConfig(**kw)
    r = np.random.default_rng(2)
    p = {k: r.normal(size=s.shape).astype(np.float32) * 0.3
         for k, s in A.attn_specs(cfg, torch.float32).items()}
    x = r.normal(size=(1, 32, 16)).astype(np.float32)
    enc = r.normal(size=(1, 5, 16)).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: _t(v) for k, v in p.items()}
    want = JA.cross_attention(jp, jnp.asarray(x),
                              JA.cross_kv(jp, jnp.asarray(enc), jcfg), jcfg)
    got = A.cross_attention(tp, _t(x), A.cross_kv(tp, _t(enc), cfg), cfg)
    _close(got, want)


# ----------------------------------------------------- the encoder-decoder
@functools.lru_cache(maxsize=None)
def _seamless(dtype="float32"):
    return _models(ARCH, dtype)


_jencode = jax.jit(JE.encode, static_argnums=2)
_jdecode_train = jax.jit(JE.decode_train, static_argnums=(3, 4))
_jstep = jax.jit(JE.decode_step, static_argnums=4)


def test_encode_and_decode_train_match_reference():
    jcfg, jp, cfg, model = _seamless()
    frames = _frames(cfg)
    x = np.random.default_rng(4).normal(
        size=(B, S, cfg.d_model)).astype(np.float32)
    jenc = _jencode(jp["encdec"], jnp.asarray(frames), jcfg)
    tenc = E.encode(model["encdec"], _t(frames), cfg)
    _close(tenc, jenc)
    want = _jdecode_train(jp["encdec"], jenc, jnp.asarray(x), jcfg, False)
    got = E.decode_train(model["encdec"], tenc, _t(x), cfg)
    _close(got, want)
    want, jc = _jdecode_train(jp["encdec"], jenc, jnp.asarray(x), jcfg, True)
    got, tc = E.decode_train(model["encdec"], tenc, _t(x), cfg,
                             collect_cache=True)
    _close(got, want)
    assert set(tc) == set(jc) == {"k", "v", "ck", "cv"}
    for name in jc:
        assert tuple(tc[name].shape) == jc[name].shape
        _close(tc[name], jc[name])


def test_decode_step_from_the_reference_cache():
    """Two encdec.decode_step calls from the reference's own cache (its
    k/v grown to S + 2 as its generate grows them; ck/cv not grown)."""
    jcfg, jp, cfg, model = _seamless()
    frames, toks = _frames(cfg), _toks(cfg)
    jenc = _jencode(jp["encdec"], jnp.asarray(frames), jcfg)
    x = JM._embed(jp, jnp.asarray(toks), jcfg)
    _, jc = _jdecode_train(jp["encdec"], jenc, x, jcfg, True)
    jc = {n: (jnp.pad(t, ((0, 0), (0, 0), (0, 2), (0, 0), (0, 0)))
              if n in ("k", "v") else t) for n, t in jc.items()}
    tc = cache_from_jax(jax.tree_util.tree_map(np.asarray, jc), cfg, "cpu")
    assert tc["k"].shape[2] == S + 2 and tc["ck"].shape[2] == F
    for i in range(2):
        xi = JM._embed(jp, jnp.asarray(toks[:, i:i + 1]), jcfg)
        want, jc = _jstep(jp["encdec"], xi, jc, jnp.int32(S + i), jcfg)
        got, tc = E.decode_step(model["encdec"], _t(xi), tc, S + i, cfg)
        _close(got, want)
        _close(tc["k"], jc["k"])
        _close(tc["v"], jc["v"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_reference(dtype):
    """model.prefill at a capacity past S holds k/v at the capacity and
    ck/cv at the F frames given (not cfg.encoder_frames, not padded); the
    logits of prefill and of two decode steps equal the reference's."""
    jcfg, jp, cfg, model = _seamless(dtype)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    frames, toks = _frames(cfg), _toks(cfg)
    jbatch = {"tokens": jnp.asarray(toks),
              "frames": jnp.asarray(frames).astype(jcfg.compute_dtype)}
    jl, jc = _jprefill(jp, jbatch, jcfg)
    tl, tc = M.prefill(model, {"tokens": _t(toks), "frames": _t(frames)},
                       cfg, capacity=S + 2)
    _close(tl, jl, tol)
    assert cfg.encoder_frames != F
    assert tuple(tc["k"].shape) == (cfg.num_layers, B, S + 2,
                                    cfg.num_kv_heads, cfg.head_dim)
    assert tuple(tc["ck"].shape) == jc["ck"].shape
    assert tc["ck"].shape[2] == F
    for name in jc:
        _close(tc[name][:, :, :jc[name].shape[2]], jc[name], tol)
    jc = {n: (jnp.pad(t, ((0, 0), (0, 0), (0, 2), (0, 0), (0, 0)))
              if n in ("k", "v") else t) for n, t in jc.items()}
    nxt = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
    for i in range(2):
        jl, jc = _jdecode(jp, jnp.asarray(nxt), jc, jnp.int32(S + i), jcfg)
        tl, tc = M.decode_step(model, _t(nxt), tc, S + i, cfg)
        _close(tl, jl, tol)
        nxt = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(
            np.int32)


def test_decode_step_skips_final_norm():
    """The decoder ends in dec_norm: a final_norm that is not zero changes
    nothing in prefill or decode, as in the reference."""
    jcfg, jp, cfg, model = _seamless()
    frames, toks = _frames(cfg), _toks(cfg)
    batch = {"tokens": _t(toks), "frames": _t(frames)}
    base, cache = M.prefill(model, batch, cfg, capacity=S + 1)
    step, _ = M.decode_step(model, _t(toks[:, :1]), cache, S, cfg)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    tree["final_norm"] = {"scale": np.full(cfg.d_model, 3.0, np.float32)}
    other = params_from_jax(tree, cfg, "cpu")
    got, cache = M.prefill(other, batch, cfg, capacity=S + 1)
    got_step, _ = M.decode_step(other, _t(toks[:, :1]), cache, S, cfg)
    assert torch.equal(got, base) and torch.equal(got_step, step)


def test_generate_with_frames_equals_reference():
    jcfg, jp, cfg, model = _seamless()
    frames, toks = _frames(cfg, b=3), _toks(cfg, b=3, s=5)
    want, _ = jgenerate(jp, jcfg, jnp.asarray(toks), 8,
                        frames=jnp.asarray(frames))
    got, aux = generate(model, cfg, toks, 8, frames=frames)
    assert got.dtype == torch.int32 and got.shape == (3, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert aux["cache"]["k"].shape[2] == 5 + 8
    assert aux["cache"]["ck"].shape[2] == F
    with pytest.raises(ValueError, match="frames"):
        generate(model, cfg, toks, 2)


def test_specs_count_the_reference():
    """The full config's parameter count and bytes (final_norm included,
    though the decoder ends in dec_norm), and the cache specs."""
    from repro.models.params import param_bytes, param_count
    from repro_torch.models import params as P

    cfg, jcfg = get_config(ARCH), jget_config(ARCH)
    specs, jspecs = M.model_specs(cfg), JM.model_specs(jcfg)
    assert "final_norm" in specs
    assert P.param_count(specs) == param_count(jspecs) == 716_452_864
    assert P.param_bytes(specs) == param_bytes(jspecs)
    got = M.decode_cache_specs(cfg, 3, 40)
    want = JM.decode_cache_specs(jcfg, 3, 40)
    assert {n: s.shape for n, s in got.items()} == {
        n: s.shape for n, s in want.items()}
    cache = M.alloc_cache(cfg, 3, 40, "meta")
    assert {n: tuple(t.shape) for n, t in cache.items()} == {
        n: s.shape for n, s in want.items()}
    assert dict(attn_config(cfg)._asdict()) == dict(
        jattn_config(jcfg)._asdict())


# ------------------------------------------------------- params_to_numpy
@pytest.mark.parametrize("arch,dtype", [
    (ARCH, "float32"), (ARCH, "bfloat16"), ("gemma2-2b", "bfloat16"),
    ("deepseek-moe-16b", "float32"), ("mamba2-370m", "float32"),
    ("jamba-v0.1-52b", "bfloat16")])
def test_params_to_numpy_inverts_params_from_jax(arch, dtype):
    jcfg, _ = _configs(arch, dtype)
    jp = jinitialize(JM.model_specs(jcfg), jax.random.PRNGKey(5))
    tree = jax.tree_util.tree_map(np.asarray, jp)
    _, cfg = _configs(arch, dtype)
    back = params_to_numpy(params_from_jax(tree, cfg, "cpu"))
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(got) == len(flat)
    for path, want in flat:
        g = got[path]
        assert g.dtype == want.dtype and g.shape == want.shape, path
        np.testing.assert_array_equal(g.view(np.uint8), want.view(np.uint8))


def test_bf16_logits_within_tolerance_of_f32():
    """bf16 seamless against f32 seamless on the same weights (rounded to
    bf16 by the reference), within BF16_TOL."""
    jcfg, jp, cfg, model = _seamless()
    jcfg16, jp16, cfg16, model16 = _seamless("bfloat16")
    frames, toks = _frames(cfg), _toks(cfg)
    batch = {"tokens": _t(toks), "frames": _t(frames)}
    lg32, _ = M.prefill(model, batch, cfg)
    lg16, _ = M.prefill(model16, batch, cfg16)
    err = float((lg16.float() - lg32).abs().max())
    assert err <= BF16_TOL["atol"] + BF16_TOL["rtol"] * float(
        lg32.abs().max())
    assert bool(torch.isfinite(lg16).all())
