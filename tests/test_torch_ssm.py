"""repro_torch's Mamba-2 SSD layer: the reference's own invariants (the
five cases of tests/test_ssm.py, run on the port), then the port against
the JAX package on the CPU on identical inputs: the chunked scan, the
layer with its cache at a length the chunk does not divide, the decode
step with two groups, and dt below dt_min, where prefill and decode
differ exactly as the reference's do.

Tolerances: f32 atol = rtol = 1e-4 against the reference (the scans sum
in another order); the invariants keep the reference's own tolerances.
bf16: BF16_TOL, about twice the largest error seen here (0.047 on
outputs of magnitude up to 3.7, three bf16 steps there: the two round
the projections' sums differently, and the gated norm carries that).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as JS
from repro.models.params import initialize as jinitialize
from repro_torch.models import ssm
from repro_torch.models.params import initialize

F32_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = dict(atol=0.1, rtol=0.02)


def _normal(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


def _inputs(b=2, s=32, h=4, p=8, n=16, seed=0):
    """(xh, bh, ch, dt, a) as numpy: the reference test's distributions."""
    xh = _normal((b, s, h, p), seed)
    bh = _normal((b, s, h, n), seed + 1, 0.5)
    ch = _normal((b, s, h, n), seed + 2, 0.5)
    dt = np.log1p(np.exp(_normal((b, s, h), seed + 3)))
    a = -np.exp(_normal((h,), seed + 4, 0.3))
    return xh, bh, ch, dt.astype(np.float32), a.astype(np.float32)


def _t(arrays):
    return [torch.as_tensor(a) for a in arrays]


def _close(got, want, tol=F32_TOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               **tol)


# ------------------------------------------- the reference's invariants
@pytest.mark.parametrize("chunk", [1, 4, 8, 32])
def test_chunked_matches_sequential(chunk):
    args = _t(_inputs())
    y_ref, h_ref = ssm.ssd_reference(*args)
    y, h = ssm.ssd_chunked(*args, chunk)
    torch.testing.assert_close(y, y_ref, atol=1e-3, rtol=1e-3)
    torch.testing.assert_close(h, h_ref, atol=1e-3, rtol=1e-3)


def test_initial_state_carries():
    args = _t(_inputs(s=16))
    h0 = torch.as_tensor(_normal((2, 4, 16, 8), 9))
    y_ref, _ = ssm.ssd_reference(*args, h0=h0)
    y, _ = ssm.ssd_chunked(*args, 4, h0=h0)
    torch.testing.assert_close(y, y_ref, atol=1e-3, rtol=1e-3)


def test_layer_decode_matches_prefill():
    """One decode step after prefill == the full forward's last position."""
    cfg = ssm.SSMConfig(d_model=32, d_state=16, d_conv=4, expand=2,
                        head_dim=8, n_groups=1, chunk=8)
    params = initialize(ssm.ssm_specs(cfg, torch.float32), 0, "cpu")
    u = torch.as_tensor(_normal((2, 17, 32)))
    full = ssm.ssm_apply(params, u, cfg)
    out_pre, cache = ssm.ssm_apply(params, u[:, :16], cfg, return_cache=True)
    step_out, _ = ssm.ssm_decode_step(params, u[:, 16:17], cache, cfg)
    torch.testing.assert_close(step_out[:, 0], full[:, 16], atol=2e-3,
                               rtol=2e-3)
    torch.testing.assert_close(out_pre, full[:, :16], atol=2e-3, rtol=2e-3)


def test_causal_conv_is_causal():
    x = torch.zeros(1, 8, 3)
    x[0, 4, :] = 1.0
    y = ssm._causal_conv(x, torch.ones(4, 3))
    assert float(y[0, :4].abs().sum()) == 0.0  # nothing before t=4
    assert float(y[0, 4:].abs().sum()) > 0.0


def test_state_is_constant_memory():
    """The decode cache's size does not depend on the sequence length."""
    cfg = ssm.SSMConfig(d_model=32, d_state=16, head_dim=8)
    total = sum(np.prod(s) for s in ssm.ssm_cache_shape(cfg, 3).values())
    assert total < 3 * 64 * 16 * 64


# ------------------------------------------------ against the reference
@pytest.mark.parametrize("chunk,h0", [(4, False), (16, True), (32, False)])
def test_ssd_chunked_matches_reference(chunk, h0):
    arrays = _inputs(s=32, seed=3)
    init = _normal((2, 4, 16, 8), 7) if h0 else None
    jy, jh = JS.ssd_chunked(*map(jnp.asarray, arrays), chunk,
                            h0=None if init is None else jnp.asarray(init))
    y, h = ssm.ssd_chunked(*_t(arrays), chunk,
                           h0=None if init is None else torch.as_tensor(init))
    _close(y, jy)
    _close(h, jh)


def _layer(cfg_kw, seed=0, dt_bias=None):
    """(reference cfg, port cfg, reference params, port params)."""
    jcfg, cfg = JS.SSMConfig(**cfg_kw), ssm.SSMConfig(**cfg_kw)
    jp = jinitialize(JS.ssm_specs(jcfg, jnp.float32), jax.random.PRNGKey(seed))
    jp = dict(jp)
    r = np.random.default_rng(seed)
    # the reference initializes these to constants; give them values
    jp["A_log"] = jnp.asarray(r.normal(size=jcfg.n_heads) * 0.5, jnp.float32)
    jp["D"] = jnp.asarray(r.normal(size=jcfg.n_heads), jnp.float32)
    jp["dt_bias"] = jnp.asarray(
        r.normal(size=jcfg.n_heads) if dt_bias is None
        else np.full(jcfg.n_heads, dt_bias), jnp.float32)
    jp["norm"] = {"scale": jnp.asarray(r.normal(size=jcfg.d_inner) * 0.1,
                                       jnp.float32)}

    def conv(t):
        return ({k: conv(v) for k, v in t.items()} if isinstance(t, dict)
                else torch.as_tensor(np.array(t)))

    return jcfg, cfg, jp, conv(jp)


SMALL = dict(d_model=32, d_state=8, d_conv=4, expand=2, head_dim=8,
             n_groups=1, chunk=16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [24, 32, 2])
def test_ssm_apply_with_cache_matches_reference(dtype, s):
    """24 tokens at chunk 16 fall back to chunk 12; 2 tokens are fewer
    than the conv's 3-tap tail, which is zero-padded on the left."""
    jcfg, cfg, jp, tp = _layer(SMALL)
    u = _normal((2, s, 32), 5)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jout, jc = JS.ssm_apply(jp, jnp.asarray(u).astype(jdt), jcfg,
                            return_cache=True)
    out, cache = ssm.ssm_apply(tp, torch.as_tensor(u).to(tdt), cfg,
                               return_cache=True)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    assert out.dtype == tdt and set(cache) == set(jc)
    _close(out, jout, tol)
    for name in jc:
        assert cache[name].dtype == tdt
        assert tuple(cache[name].shape) == jc[name].shape
        _close(cache[name], jc[name], tol)


def test_chunk_falls_back_to_the_largest_divisor():
    assert ssm._chunk_for(24, 16) == 12
    assert ssm._chunk_for(8224, 256) == 32
    assert ssm._chunk_for(8192, 256) == 256
    assert ssm._chunk_for(7, 16) == 7
    assert ssm._chunk_for(257, 256) == 1


def test_groups_repeat_over_heads_not_tile():
    """Two groups over four heads: heads 0, 1 read group 0 (jnp.repeat),
    not groups 0, 1, 0, 1 (a tile)."""
    cfg = ssm.SSMConfig(d_model=16, d_state=4, expand=2, head_dim=8,
                        n_groups=2)
    bb = _normal((2, 3, 8))
    got = ssm._heads(torch.as_tensor(bb), cfg, True).numpy()
    g = bb.reshape(2, 3, 2, 4)
    np.testing.assert_array_equal(got, np.asarray(jnp.repeat(g, 2, axis=2)))
    assert not np.array_equal(got, np.tile(g, (1, 1, 2, 1)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_decode_step_two_groups_matches_reference(dtype):
    kw = dict(SMALL, n_groups=2)
    jcfg, cfg, jp, tp = _layer(kw, seed=2)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    u = _normal((3, 10, 32), 6)
    _, jc = JS.ssm_apply(jp, jnp.asarray(u[:, :8]).astype(jdt), jcfg,
                         return_cache=True)
    cache = {k: torch.as_tensor(np.array(v.astype(jnp.float32))).to(tdt)
             for k, v in jc.items()}
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    for t in (8, 9):
        jout, jc = JS.ssm_decode_step(
            jp, jnp.asarray(u[:, t:t + 1]).astype(jdt), jc, jcfg)
        out, cache = ssm.ssm_decode_step(
            tp, torch.as_tensor(u[:, t:t + 1]).to(tdt), cache, cfg)
        _close(out, jout, tol)
        for name in jc:
            assert cache[name].dtype == tdt
            _close(cache[name], jc[name], tol)


def test_dt_below_dt_min_prefill_clips_decode_does_not():
    """A dt_bias of -12 puts softplus near 6e-6, below dt_min: the
    prefill clips dt to dt_min, the decode step keeps it. The port's two
    paths differ where the reference's do, and each equals its reference
    counterpart."""
    jcfg, cfg, jp, tp = _layer(SMALL, seed=4, dt_bias=-12.0)
    # no skip term: the gated norm scales the scan's output up to O(1)
    jp["D"], tp["D"] = jnp.zeros_like(jp["D"]), torch.zeros_like(tp["D"])
    u = _normal((2, 17, 32), 8)
    jfull = JS.ssm_apply(jp, jnp.asarray(u), jcfg)
    _, jc = JS.ssm_apply(jp, jnp.asarray(u[:, :16]), jcfg, return_cache=True)
    jstep, _ = JS.ssm_decode_step(jp, jnp.asarray(u[:, 16:]), jc, jcfg)
    full = ssm.ssm_apply(tp, torch.as_tensor(u), cfg)
    _, cache = ssm.ssm_apply(tp, torch.as_tensor(u[:, :16]), cfg,
                             return_cache=True)
    step, _ = ssm.ssm_decode_step(tp, torch.as_tensor(u[:, 16:]), cache, cfg)
    _close(full, jfull)
    _close(step, jstep)
    gap = float((step[:, 0] - full[:, 16]).abs().max())
    jgap = float(jnp.abs(jstep[:, 0] - jfull[:, 16]).max())
    assert gap > 1e-3 and abs(gap - jgap) <= 1e-4 + 1e-4 * jgap
