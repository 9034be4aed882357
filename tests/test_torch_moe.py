"""repro_torch's MoE layer: the reference's own invariants (the six cases
of tests/test_moe.py, run on the port), then the port against the JAX
package on the CPU on identical inputs: routing, capacity, dispatch, the
layer with its four aux values, and the loss.

Tolerances: the router's top-k ids and the dispatch rows are bit-equal,
ties included. The renormalized weights agree within ROUTE_TOL (two f32
ulps at 1.0): XLA:CPU's exp and torch's differ in the last bit on about
one input in ten, so the probabilities do too; 61-95 % of the weights
were bit-equal on such inputs, the rest at most 1.2e-7 apart. The
layer: f32 atol = rtol = 1e-4; bf16 BF16_TOL, above the largest error
seen here (0.0156 on outputs of magnitude up to 3.3: one bf16 step
there, 2^-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as JMoE
from repro.models.params import initialize as jinitialize
from repro_torch.models import moe
from repro_torch.models.params import initialize

F32_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)
ROUTE_TOL = dict(atol=2.4e-7, rtol=0)


def _cfgs(**kw):
    return moe.MoEConfig(**kw), JMoE.MoEConfig(**kw)


def _normal(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


def _params(d, cfg, seed=0):
    """The reference's weights for (d, cfg) and the port's copy of them."""
    jp = jinitialize(JMoE.moe_specs(d, cfg, jnp.float32),
                     jax.random.PRNGKey(seed))

    def conv(t):
        return ({k: conv(v) for k, v in t.items()} if isinstance(t, dict)
                else torch.as_tensor(np.array(t)))

    return jp, conv(jp)


# ------------------------------------------- the reference's invariants
def test_routing_weights_renormalized():
    cfg, _ = _cfgs(num_experts=8, top_k=2, d_ff_expert=16)
    w, idx, _ = moe._route(torch.as_tensor(_normal((32, 8))), cfg)
    torch.testing.assert_close(w.sum(dim=1), torch.ones(32), atol=1e-5,
                               rtol=0)
    assert int(idx.max()) < 8


def test_capacity_drop_fraction_reported():
    cfg, _ = _cfgs(num_experts=4, top_k=1, d_ff_expert=8,
                   capacity_factor=0.5)
    params = initialize(moe.moe_specs(16, cfg, torch.float32), 0, "cpu")
    x = torch.as_tensor(_normal((2, 32, 16)))
    out, aux = moe.moe_apply(params, x, cfg)
    assert out.shape == x.shape
    assert float(aux["moe_dropped_frac"]) > 0.0  # cf=0.5 must drop


def test_no_drops_at_high_capacity():
    cfg, _ = _cfgs(num_experts=4, top_k=2, d_ff_expert=8,
                   capacity_factor=4.0)
    params = initialize(moe.moe_specs(16, cfg, torch.float32), 0, "cpu")
    _, aux = moe.moe_apply(params, torch.as_tensor(_normal((2, 16, 16))),
                           cfg)
    assert float(aux["moe_dropped_frac"]) == 0.0


def test_aux_loss_uniform_router_is_one():
    """Switch aux loss equals 1 exactly under perfectly uniform load."""
    cfg, _ = _cfgs(num_experts=4, top_k=1, d_ff_expert=8)
    logits = torch.as_tensor(_normal((4000, 4), scale=1e-4))
    _, _, aux = moe._route(logits, cfg)
    assert abs(float(aux["moe_aux_loss"]) - 1.0) < 0.05


def test_shared_experts_contribute():
    cfg, _ = _cfgs(num_experts=4, top_k=1, d_ff_expert=8, num_shared=2,
                   capacity_factor=2.0)
    params = initialize(moe.moe_specs(16, cfg, torch.float32), 0, "cpu")
    x = torch.as_tensor(_normal((1, 8, 16)))
    out, _ = moe.moe_apply(params, x, cfg)
    zeroed = dict(params, shared={k: torch.zeros_like(v)
                                  for k, v in params["shared"].items()})
    out2, _ = moe.moe_apply(zeroed, x, cfg)
    assert float((out - out2).abs().max()) > 1e-6


def test_dispatch_gather_roundtrip_identity_experts():
    """wo zeroed: the output is 0, the routing machinery adds nothing."""
    cfg, _ = _cfgs(num_experts=4, top_k=2, d_ff_expert=8,
                   capacity_factor=4.0)
    params = initialize(moe.moe_specs(16, cfg, torch.float32), 0, "cpu")
    params["wo"] = torch.zeros_like(params["wo"])
    out, _ = moe.moe_apply(params, torch.as_tensor(_normal((1, 8, 16))), cfg)
    assert float(out.abs().max()) <= 1e-6


# ------------------------------------------------ against the reference
def _ties(t, e, seed=0):
    """Logits with exact ties: integers in [-2, 2], whole rows equal, and
    every expert equal in a few rows."""
    x = np.round(_normal((t, e), seed, scale=1.5)).clip(-2, 2)
    x[::7] = x[0]
    x[::5] = 0.0
    return x.astype(np.float32)


@pytest.mark.parametrize("e,k,t", [(8, 2, 64), (64, 6, 512), (16, 4, 300),
                                   (4, 2, 33)])
@pytest.mark.parametrize("kind", ["random", "ties"])
def test_route_matches_reference(e, k, t, kind):
    cfg, jcfg = _cfgs(num_experts=e, top_k=k, d_ff_expert=8)
    x = _normal((t, e), seed=e, scale=2.0) if kind == "random" else \
        _ties(t, e, seed=e)
    jw, ji, ja = JMoE._route(jnp.asarray(x), jcfg)
    w, idx, aux = moe._route(torch.as_tensor(x), cfg)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), **ROUTE_TOL)
    assert set(aux) == set(ja)
    for key in ja:
        np.testing.assert_allclose(float(aux[key]), float(ja[key]),
                                   **F32_TOL)
    if kind == "ties":  # all-equal rows take experts 0..k-1, in order
        np.testing.assert_array_equal(idx[::5].numpy(),
                                      np.tile(np.arange(k), (len(x[::5]), 1)))


@pytest.mark.parametrize("t,k,e,cf,want", [
    (20, 2, 4, 1.25, 12),   # 12.5 rounds to even
    (108, 1, 8, 1.0, 14),   # 13.5 rounds to even
    (1, 6, 64, 1.25, 8),    # a decode step: the floor of 8
    (3, 4, 2, 0.1, 8),      # k over round(): the floor still holds
    (4096, 6, 64, 1.25, 480),
])
def test_capacity_rounds_half_to_even(t, k, e, cf, want):
    cfg, _ = _cfgs(num_experts=e, top_k=k, d_ff_expert=8,
                   capacity_factor=cf)
    assert moe.capacity(t, cfg) == want


def _reference_dispatch(idx, e, capacity):
    """src/repro/models/moe.py:114-129, the reference's inline dispatch."""
    running = jnp.zeros((e,), jnp.int32)
    pos_list = []
    for kk in range(idx.shape[1]):
        mask_k = jax.nn.one_hot(idx[:, kk], e, dtype=jnp.int32)
        within = jnp.cumsum(mask_k, axis=0) - mask_k
        pos_k = jnp.take_along_axis(
            within + running[None, :], idx[:, kk:kk + 1], axis=1)[:, 0]
        running = running + mask_k.sum(axis=0)
        pos_list.append(pos_k)
    pos = jnp.stack(pos_list, axis=1)
    keep = pos < capacity
    return pos, keep, jnp.where(keep, idx * capacity + pos, e * capacity)


@pytest.mark.parametrize("e,k,t,cf", [(4, 2, 40, 0.5), (8, 2, 64, 1.25),
                                      (64, 6, 200, 1.25), (4, 1, 16, 4.0)])
def test_dispatch_matches_reference(e, k, t, cf):
    cfg, jcfg = _cfgs(num_experts=e, top_k=k, d_ff_expert=8,
                      capacity_factor=cf)
    x = _normal((t, e), seed=t)
    _, ji, _ = JMoE._route(jnp.asarray(x), jcfg)
    _, idx, _ = moe._route(torch.as_tensor(x), cfg)
    cap = moe.capacity(t, cfg)
    jpos, jkeep, jdest = _reference_dispatch(ji, e, cap)
    pos, keep, dest = moe.dispatch(idx, e, cap)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    np.testing.assert_array_equal(dest.numpy(), np.asarray(jdest))
    if cf < 1:
        assert not bool(keep.all())  # copies were dropped


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shared", [0, 2])
@pytest.mark.parametrize("b,s,cf", [(2, 24, 1.25), (2, 24, 0.5), (3, 1, 1.25)])
def test_moe_apply_matches_reference(dtype, shared, b, s, cf):
    """Prefill (t = B·S, with and without drops) and a decode step
    (t = B); the output and all four aux values."""
    cfg, jcfg = _cfgs(num_experts=8, top_k=2, d_ff_expert=32,
                      num_shared=shared, capacity_factor=cf)
    jp, tp = _params(32, jcfg, seed=shared)
    x = _normal((b, s, 32), seed=s)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jout, jaux = JMoE.moe_apply(jp, jnp.asarray(x).astype(jdt), jcfg)
    out, aux = moe.moe_apply(tp, torch.as_tensor(x).to(tdt), cfg)
    assert out.dtype == tdt
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(jout.astype(jnp.float32)), **tol)
    assert set(aux) == set(jaux) == {"moe_aux_loss", "moe_z_loss",
                                     "moe_expert_frac_max",
                                     "moe_dropped_frac"}
    for key in jaux:
        np.testing.assert_allclose(float(aux[key]), float(jaux[key]),
                                   **F32_TOL)
    if cf < 1:
        assert float(aux["moe_dropped_frac"]) > 0


def test_moe_loss_matches_reference():
    cfg, jcfg = _cfgs(num_experts=8, top_k=2, d_ff_expert=16,
                      router_z_loss=3e-3, aux_loss_weight=2e-2)
    x = _normal((64, 8), scale=3.0)
    _, _, jaux = JMoE._route(jnp.asarray(x), jcfg)
    _, _, aux = moe._route(torch.as_tensor(x), cfg)
    np.testing.assert_allclose(float(moe.moe_loss(aux, cfg)),
                               float(JMoE.moe_loss(jaux, jcfg)), **F32_TOL)
