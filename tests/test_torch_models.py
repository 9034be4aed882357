"""repro_torch's dense decoder against the JAX package's, on the CPU, on
identical inputs: numpy-seeded activations through the layers, the two
attention paths and decode attention, and the reference's weights
(``repro.models.params.initialize``) carried into the port by
``params_from_jax`` for whole-model prefill and decode on the smoke
configs. The specs of every dense full config count the reference's
parameters and bytes (no allocation).

Tolerances: f32 atol = rtol = 1e-4 (the two run their sums in another
order); bf16 BF16_TOL (atol 0.25, rtol 0.02). Measured on these configs:
gemma2's logits differ by at most 0.17 (prefill) and 0.16 (decode), a
step or two of bf16 near the final softcap's 30, where a step is 0.125;
minitron's by 0.03.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import model as JM
from repro.models.params import initialize as jinitialize
from repro.models.params import param_bytes as jparam_bytes
from repro.models.params import param_count as jparam_count
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import params as P
from repro_torch.models.convert import cache_from_jax, params_from_jax

F32_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = dict(atol=0.25, rtol=0.02)
DENSE_ARCHS = ["gemma2-2b", "minitron-8b", "llama3-405b", "qwen1.5-110b",
               "chameleon-34b"]
B, S = 2, 16


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol=F32_TOL):
    np.testing.assert_allclose(got.float().numpy(), _np(want), **tol)


def _rng(seed=0):
    return np.random.default_rng(seed)


def _configs(arch, dtype="float32", **over):
    """The smoke config of ``arch`` in both packages, in ``dtype``."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jcfg = dataclasses.replace(jget_smoke(arch), param_dtype=jdt,
                               compute_dtype=jdt, **over)
    tcfg = dataclasses.replace(get_smoke_config(arch), param_dtype=tdt,
                               compute_dtype=tdt, **over)
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _jparams(jcfg):
    return jinitialize(JM.model_specs(jcfg), jax.random.PRNGKey(0))


# the reference's serving entry points, compiled once per config and shape
_jprefill = jax.jit(JM.prefill, static_argnums=2)
_jdecode = jax.jit(JM.decode_step, static_argnums=4)


def _models(arch, dtype="float32", **over):
    """(jcfg, reference params, cfg, the port's model on the same
    weights)."""
    jcfg, tcfg = _configs(arch, dtype, **over)
    jp = _jparams(jcfg)
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                            "cpu")
    return jcfg, jp, tcfg, model


def _tokens(cfg, b=B, s=S, seed=1):
    return _rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


# ------------------------------------------------------------- layers
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_reference(dtype):
    x = _rng().normal(size=(3, 5, 64)).astype(np.float32) * 3
    scale = _rng(1).normal(size=64).astype(np.float32) * 0.1
    got = L.rmsnorm_apply({"scale": torch.as_tensor(scale)},
                          torch.as_tensor(x).to(getattr(torch, dtype)))
    want = JL.rmsnorm_apply({"scale": jnp.asarray(scale)},
                            jnp.asarray(x).astype(getattr(jnp, dtype)))
    assert str(got.dtype).endswith(dtype)
    _close(got, want, F32_TOL if dtype == "float32" else BF16_TOL)


def test_rope_matches_reference():
    x = _rng().normal(size=(2, 40, 3, 16)).astype(np.float32)
    pos = np.concatenate([np.arange(20), 4090 + np.arange(20)])
    got = L.rope(torch.as_tensor(x), torch.as_tensor(pos), 10000.0)
    want = JL.rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
    _close(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_softcap_matches_reference(dtype):
    x = _rng().normal(size=(4, 300)).astype(np.float32) * 60
    got = L.softcap(torch.as_tensor(x).to(getattr(torch, dtype)), 30.0)
    want = JL.softcap(jnp.asarray(x).astype(getattr(jnp, dtype)), 30.0)
    assert str(got.dtype).endswith(dtype)
    _close(got, want, F32_TOL if dtype == "float32" else BF16_TOL)


@pytest.mark.parametrize("act", ["silu", "gelu", "relu"])
def test_mlp_matches_reference(act):
    r = _rng()
    p = {k: r.normal(size=s).astype(np.float32) * 0.2 for k, s in
         (("wi_gate", (32, 48)), ("wi_up", (32, 48)), ("wo", (48, 32)))}
    x = r.normal(size=(2, 5, 32)).astype(np.float32)
    got = L.mlp_apply({k: torch.as_tensor(v) for k, v in p.items()},
                      torch.as_tensor(x), act)
    want = JL.mlp_apply({k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x), act)
    _close(got, want)


# ----------------------------------------------------------- attention
def _qkv(sq=64, sk=64, h=4, kv=2, d=16, seed=0):
    r = _rng(seed)
    return (r.normal(size=(2, sq, h, d)).astype(np.float32),
            r.normal(size=(2, sk, kv, d)).astype(np.float32),
            r.normal(size=(2, sk, kv, d)).astype(np.float32))


@pytest.mark.parametrize("window", [None, 8, 24])
@pytest.mark.parametrize("cap", [None, 50.0])
def test_attend_dense_matches_reference(window, cap):
    q, k, v = _qkv()
    pos = np.arange(64)
    got = A._attend_dense(*map(torch.as_tensor, (q, k, v)), causal=True,
                          window=window, logit_cap=cap,
                          q_positions=torch.as_tensor(pos),
                          k_positions=torch.as_tensor(pos))
    want = JA._attend_dense(*map(jnp.asarray, (q, k, v)), causal=True,
                            window=window, logit_cap=cap,
                            q_positions=jnp.asarray(pos),
                            k_positions=jnp.asarray(pos))
    _close(got, want)


@pytest.mark.parametrize("window", [None, 8, 24, 56])
@pytest.mark.parametrize("cap", [None, 50.0])
def test_attend_blockwise_matches_reference(window, cap):
    """Chunks of 16 over 64 positions: global, and the local windows of 8
    and 24 slide a window + chunk key slice past padded keys (k_pos < 0
    masked); a window of 56 is no smaller than the keys less a chunk, so
    it runs the global range with the window mask."""
    q, k, v = _qkv()
    got = A._attend_blockwise(*map(torch.as_tensor, (q, k, v)), causal=True,
                              window=window, logit_cap=cap, chunk_q=16)
    want = JA._attend_blockwise(*map(jnp.asarray, (q, k, v)), causal=True,
                                window=window, logit_cap=cap, chunk_q=16)
    _close(got, want)


def _attn_params(acfg, seed=0):
    specs = JA.attn_specs(acfg, jnp.float32)
    jp = jinitialize(specs, jax.random.PRNGKey(seed))
    return jp, {k: torch.as_tensor(np.asarray(v)) for k, v in jp.items()}


ACFG = dict(d_model=32, num_heads=4, num_kv_heads=2, head_dim=16,
            logit_cap=50.0, query_scale=0.3, rope_theta=10000.0,
            chunk_q=16, dense_threshold=32)


@pytest.mark.parametrize("s", [32, 40, 64])
@pytest.mark.parametrize("window", [None, 8])
def test_self_attention_takes_the_reference_path(s, window):
    """s <= 32 or s % 16 != 0 runs dense, 64 blockwise: the port picks the
    reference's path, output and keys alike."""
    acfg = JA.AttnConfig(**ACFG, qkv_bias=True)
    jp, tp = _attn_params(acfg)
    x = _rng(2).normal(size=(2, s, 32)).astype(np.float32)
    got, (gk, gv) = A.self_attention(tp, torch.as_tensor(x),
                                     A.AttnConfig(**ACFG, qkv_bias=True),
                                     window=window)
    want, (wk, wv) = JA.self_attention(jp, jnp.asarray(x), acfg,
                                       window=window)
    _close(got, want)
    _close(gk, wk)
    _close(gv, wv)


@pytest.mark.parametrize("ring", [False, True])
def test_decode_attention_matches_reference(ring):
    """One step at positions inside and past a window of 8 (ring: a cache
    of the window's capacity, writes wrapping at pos % 8)."""
    acfg = JA.AttnConfig(**ACFG)
    jp, tp = _attn_params(acfg)
    r = _rng(3)
    cap = 8 if ring else 24
    ck = r.normal(size=(2, cap, 2, 16)).astype(np.float32)
    cv = r.normal(size=(2, cap, 2, 16)).astype(np.float32)
    for pos in (3, 7, 12, 21):
        x = r.normal(size=(2, 1, 32)).astype(np.float32)
        got, gk, gv = A.decode_attention(
            tp, torch.as_tensor(x), torch.as_tensor(ck.copy()),
            torch.as_tensor(cv.copy()), pos, A.AttnConfig(**ACFG),
            window=8, ring=ring)
        want, wk, wv = JA.decode_attention(
            jp, jnp.asarray(x), jnp.asarray(ck), jnp.asarray(cv),
            jnp.int32(pos), acfg, window=8, ring=ring)
        _close(got, want)
        _close(gk, wk)
        _close(gv, wv)
        ck, cv = np.asarray(wk), np.asarray(wv)


# --------------------------------------------------------------- model
@pytest.mark.parametrize("arch", ["gemma2-2b", "minitron-8b"])
def test_prefill_and_decode_match_reference(arch):
    """Prefill logits and cache, then two decode steps (one from the
    reference's own cache carried over by cache_from_jax), f32."""
    jcfg, jp, cfg, model = _models(arch)
    toks = _tokens(cfg)
    jl, jc = _jprefill(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    tl, tc = M.prefill(model, {"tokens": torch.as_tensor(toks)}, cfg)
    _close(tl, jl)
    for key, e in jc["blocks"].items():
        _close(tc["blocks"][key]["k"], e["k"])
        _close(tc["blocks"][key]["v"], e["v"])
    from repro.serve.serve_step import _grow_cache

    jc = _grow_cache(jc, S + 2)
    tc = cache_from_jax(jax.tree_util.tree_map(np.asarray, jc), cfg, "cpu")
    nxt = np.asarray(jnp.argmax(jl[:, -1], axis=-1))[:, None].astype(
        np.int32)
    for pos in (S, S + 1):
        jl, jc = _jdecode(jp, jnp.asarray(nxt), jc, jnp.int32(pos),
                                jcfg)
        tl, tc = M.decode_step(model, torch.as_tensor(nxt), tc, pos, cfg)
        _close(tl, jl)
        nxt = np.asarray(jnp.argmax(jl[:, -1], axis=-1))[:, None].astype(
            np.int32)


@pytest.mark.parametrize("arch", ["gemma2-2b", "minitron-8b"])
def test_prefill_and_decode_match_reference_bf16(arch):
    jcfg, jp, cfg, model = _models(arch, "bfloat16")
    toks = _tokens(cfg)
    jl, jc = _jprefill(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    tl, tc = M.prefill(model, {"tokens": torch.as_tensor(toks)}, cfg,
                       capacity=S + 1)
    assert tl.dtype == torch.bfloat16
    _close(tl, jl, BF16_TOL)
    from repro.serve.serve_step import _grow_cache

    nxt = np.asarray(jnp.argmax(jl[:, -1], axis=-1))[:, None].astype(
        np.int32)
    jl, _ = _jdecode(jp, jnp.asarray(nxt), _grow_cache(jc, S + 1),
                           jnp.int32(S), jcfg)
    tl, _ = M.decode_step(model, torch.as_tensor(nxt), tc, S, cfg)
    _close(tl, jl, BF16_TOL)


def test_blockwise_prefill_past_the_window_matches_reference():
    """gemma2's smoke config with the chunk at 16 and the dense threshold
    at 32: a 64-token prefill runs blockwise, its local layers sliding a
    24-key slice past the window of 8."""
    over = dict(attn_chunk_q=16, attn_dense_threshold=32)
    jcfg, jp, cfg, model = _models("gemma2-2b", **over)
    toks = _tokens(cfg, s=64)
    jl, jc = _jprefill(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    tl, tc = M.prefill(model, {"tokens": torch.as_tensor(toks)}, cfg)
    _close(tl, jl)
    _close(tc["blocks"]["sub0"]["k"], jc["blocks"]["sub0"]["k"])


def test_dense_first_layer_matches_reference():
    """deepseek's dense first layer, on a dense config: its own FF width,
    its own cache entry."""
    over = dict(num_layers=3, dense_first_layer=True, dense_first_d_ff=96)
    jcfg, jp, cfg, model = _models("minitron-8b", **over)
    assert "first_layer" in model
    toks = _tokens(cfg)
    jl, jc = _jprefill(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    tl, tc = M.prefill(model, {"tokens": torch.as_tensor(toks)}, cfg,
                       capacity=S + 1)
    _close(tl, jl)
    _close(tc["first_layer"]["k"][:, :S], jc["first_layer"]["k"])
    from repro.serve.serve_step import _grow_cache

    jl, _ = _jdecode(jp, jnp.asarray(toks[:, :1]),
                           _grow_cache(jc, S + 1), jnp.int32(S), jcfg)
    tl, _ = M.decode_step(model, torch.as_tensor(toks[:, :1]), tc, S, cfg)
    _close(tl, jl)


def test_qkv_bias_matches_reference():
    """qwen's QKV bias, with the reference's zero-initialized biases set
    to values."""
    jcfg, jp, cfg, _ = _models("qwen1.5-110b")
    jp = jax.tree_util.tree_map(lambda a: a, jp)  # new dicts: the cache's
    r = _rng(5)
    attn = jp["blocks"]["sub0"]["attn"]
    for name in ("bq", "bk", "bv"):
        attn[name] = jnp.asarray(r.normal(size=attn[name].shape),
                                 jnp.float32)
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), cfg,
                            "cpu")
    toks = _tokens(cfg)
    jl, _ = _jprefill(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    tl, _ = M.prefill(model, {"tokens": torch.as_tensor(toks)}, cfg)
    _close(tl, jl)


@pytest.mark.parametrize("arch", ["gemma2-2b", "minitron-8b"])
def test_prefill_decode_consistency(arch):
    """Decoding token S-1 from a prefill of S-1 tokens gives the logits of
    a prefill of all S at its last position (the port alone, f32)."""
    _, _, cfg, model = _models(arch)
    toks = torch.as_tensor(_tokens(cfg))
    full, _ = M.prefill(model, {"tokens": toks}, cfg)
    _, cache = M.prefill(model, {"tokens": toks[:, :S - 1]}, cfg,
                         capacity=S)
    lg, _ = M.decode_step(model, toks[:, S - 1:], cache, S - 1, cfg)
    torch.testing.assert_close(lg, full, **F32_TOL)


# ------------------------------------------------------- specs, state
@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_param_count_and_bytes_equal_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    specs, jspecs = M.model_specs(cfg), JM.model_specs(jcfg)
    assert P.param_count(specs) == jparam_count(jspecs)
    assert P.param_bytes(specs) == jparam_bytes(jspecs)
    assert cfg.param_count() == jcfg.param_count()
    if arch == "gemma2-2b":
        assert (P.param_count(specs), P.param_bytes(specs)) == (
            2_614_341_888, 5_229_167_616)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_copy_the_reference(arch):
    """Every field of every config, full and smoke, as the reference has
    it (dtypes by name; the MoE and SSM configs field by field)."""
    for ours, theirs in ((get_config(arch), jget_config(arch)),
                         (get_smoke_config(arch), jget_smoke(arch))):
        for f in dataclasses.fields(ours):
            a, b = getattr(ours, f.name), getattr(theirs, f.name)
            if f.name.endswith("_dtype"):
                assert str(a).rsplit(".", 1)[-1] == np.dtype(b).name
            elif f.name in ("moe", "ssm") and a is not None:
                assert tuple(a) == tuple(b)
            elif f.name == "pattern":
                assert [dataclasses.astuple(d) for d in a] == [
                    dataclasses.astuple(d) for d in b]
            else:
                assert a == b, (arch, f.name)


def test_params_from_jax_checks_every_leaf():
    jcfg, jp, cfg, model = _models("minitron-8b")
    tree = jax.tree_util.tree_map(np.asarray, jp)
    names = {n for n, _ in model.named_parameters()}
    assert "blocks.sub0.attn.wq" in names and "embed.embedding" in names
    assert list(model.reference_leaves()) == sorted(
        names, key=lambda n: n.split("."))
    torch.testing.assert_close(
        model.blocks.sub0.mlp.wo,
        torch.as_tensor(tree["blocks"]["sub0"]["mlp"]["wo"]))
    bad = dict(tree, extra={"w": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="extra leaves"):
        params_from_jax(bad, cfg, "cpu")
    bad = dict(tree)
    del bad["final_norm"]
    with pytest.raises(ValueError, match="missing leaves"):
        params_from_jax(bad, cfg, "cpu")
    bad = dict(tree, final_norm={"scale": np.zeros(7, np.float32)})
    with pytest.raises(ValueError, match="final_norm.scale"):
        params_from_jax(bad, cfg, "cpu")
    bf16 = jax.tree_util.tree_map(
        lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)), jp)
    with pytest.raises(ValueError, match="bfloat16"):
        params_from_jax(bf16, cfg, "cpu")


def test_initialize_follows_the_reference_rules():
    """zeros for norms, std 1 for the embedding, 1/sqrt(fan_in) for scaled
    weights; one generator seed gives the same tensors again."""
    cfg = dataclasses.replace(get_smoke_config("gemma2-2b"), d_model=256,
                              vocab_size=2048, d_ff=512)
    specs = M.model_specs(cfg)
    a = P.initialize(specs, 3, "cpu")
    b = P.initialize(specs, 3, "cpu")
    c = P.initialize(specs, 4, "cpu")
    wq = a["blocks"]["sub0"]["attn"]["wq"]
    assert torch.equal(wq, b["blocks"]["sub0"]["attn"]["wq"])
    assert not torch.equal(wq, c["blocks"]["sub0"]["attn"]["wq"])
    assert wq.dtype == torch.bfloat16
    assert not a["final_norm"]["scale"].any()
    assert a["final_norm"]["scale"].dtype == torch.float32
    emb = a["embed"]["embedding"].float()
    assert abs(float(emb.std()) - 1.0) < 0.02
    assert abs(float(wq.float().std()) * 256 ** 0.5 - 1.0) < 0.05
    wo = a["blocks"]["sub0"]["attn"]["wo"].float()  # fan-in heads x dim
    assert abs(float(wo.std()) * (4 * 16) ** 0.5 - 1.0) < 0.05
    model = M.Model(cfg, a)
    assert sum(p.numel() for p in model.parameters()) == P.param_count(specs)
