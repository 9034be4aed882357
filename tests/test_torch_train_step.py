"""repro_torch's optimizer, compression and train step against the JAX
package's, on the CPU: ``optimizer.apply`` (AdamW and SGD with momentum,
f32 and bf16 state, f32 and bf16 parameters) over three steps on the
same gradients, ``schedule`` through warmup, decay and its end,
``ef_quantize`` bit for bit, a ``grad_accum=4`` step (f32 gradients, the
last microbatch's metrics) and a compressed step against the
reference's, and recomputation (remat) on against off, bit for bit.

Tolerances: with f32 state, parameters and moments at atol = rtol = 1e-6
(measured: at most 2.4e-7, the f32 step at the parameters' magnitude).
With bf16 state the reference and the port compute the same f32 value
to an ulp or two (XLA:CPU contracts some products into FMAs), and where
that value lies at a bf16 rounding boundary the stored moment is one
bf16 step away: moments at rtol 2^-8, and parameters at atol 1e-6 plus
what such a step moves an update in three steps, 3 lr 2^-8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import compress as JC
from repro.train import optimizer as JO
from repro.train import train_step as JTS
from repro_torch.train import compress as C
from repro_torch.train import optimizer as O
from repro_torch.train import train_step as TS
from test_torch_models import _close, _models
from test_torch_train import (assert_grads_close, jax_grads_by_path,
                              to_jax, to_torch, train_batch)

SHAPES = {"a.w": (64, 32), "b": (100,), "c.d.e": (3, 5, 7)}
LR = 1e-2


def _same(x, dtype):
    """numpy f32 -> (jax, torch) in ``dtype``, equal bits."""
    j = jnp.asarray(x).astype(getattr(jnp, dtype))
    t = torch.as_tensor(np.array(j.astype(jnp.float32))).to(
        getattr(torch, dtype))
    return j, t


def _host(t):
    return np.asarray(jnp.asarray(t, jnp.float32)) if not isinstance(
        t, torch.Tensor) else t.float().numpy()


@pytest.mark.parametrize("pdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["adamw", "sgdm"])
def test_apply_matches_reference_over_three_steps(name, sdtype, pdtype):
    kw = dict(name=name, lr=LR, warmup_steps=2, total_steps=10)
    jcfg = JO.OptConfig(state_dtype=getattr(jnp, sdtype), **kw)
    cfg = O.OptConfig(state_dtype=getattr(torch, sdtype), **kw)
    r = np.random.default_rng(0)
    pairs = {k: _same(r.normal(size=s).astype(np.float32), pdtype)
             for k, s in SHAPES.items()}
    jp = {k: j for k, (j, _) in pairs.items()}
    tp = {k: t for k, (_, t) in pairs.items()}
    js, ts = JO.init(jcfg, jp), O.init(cfg, tp)
    step = jax.jit(lambda p, g, s: JO.apply(jcfg, p, g, s))
    f32 = sdtype == "float32"
    ptol = dict(atol=1e-6 if f32 else 1e-6 + 3 * LR * 2 ** -8, rtol=1e-6)
    mtol = dict(atol=1e-6, rtol=1e-6) if f32 else dict(atol=0, rtol=2 ** -8)
    for _ in range(3):
        grads = {k: _same((r.normal(size=s) * 10.0 ** r.uniform(
            -6, 0, size=s)).astype(np.float32), pdtype)
            for k, s in SHAPES.items()}
        jp, js, jm = step(jp, {k: j for k, (j, _) in grads.items()}, js)
        out, ts, tm = O.apply(cfg, tp, {k: t for k, (_, t) in
                                        grads.items()}, ts)
        assert out is tp
        for k in SHAPES:
            assert tp[k].dtype == getattr(torch, pdtype)
            assert ts.mu[k].dtype == getattr(torch, sdtype)
            np.testing.assert_allclose(_host(tp[k]), _host(jp[k]), **ptol)
            np.testing.assert_allclose(_host(ts.mu[k]), _host(js.mu[k]),
                                       **mtol)
            np.testing.assert_allclose(_host(ts.nu[k]), _host(js.nu[k]),
                                       **mtol)
        assert int(ts.step) == int(js.step)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)


@pytest.mark.parametrize("step", [0, 3, 10, 55, 100, 150])
def test_schedule_matches_reference(step):
    """Warmup (0, 3), its end (10), mid-decay (55), the end (100) and
    past it (150)."""
    jcfg = JO.OptConfig(lr=3e-3, warmup_steps=10, total_steps=100)
    cfg = O.OptConfig(lr=3e-3, warmup_steps=10, total_steps=100)
    want = JO.schedule(jcfg, jnp.int32(step))
    got = O.schedule(cfg, torch.tensor(step, dtype=torch.int32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=0)


@pytest.mark.parametrize("gdtype", ["float32", "bfloat16"])
def test_ef_quantize_bit_equal(gdtype):
    """Four steps of error feedback over leaves of assorted magnitudes,
    one all zeros: the dequantized grads and the carried errors equal the
    reference's bit for bit."""
    r = np.random.default_rng(3)
    shapes = {"x": (257,), "y": (16, 9), "z": (5,)}
    jerr = {k: jnp.zeros(s, jnp.float32) for k, s in shapes.items()}
    terr = C.init_error_state({k: torch.zeros(s) for k, s in shapes.items()})
    for i in range(4):
        g = {k: (r.normal(size=s) * 10.0 ** r.uniform(-4, 1)).astype(
            np.float32) for k, s in shapes.items()}
        g["z"] = np.zeros(5, np.float32)
        pairs = {k: _same(v, gdtype) for k, v in g.items()}
        jdq, jerr = JC.ef_quantize({k: j for k, (j, _) in pairs.items()},
                                   jerr)
        tdq, terr = C.ef_quantize({k: t for k, (_, t) in pairs.items()},
                                  terr)
        for k in shapes:
            assert tdq[k].dtype == getattr(torch, gdtype)
            np.testing.assert_array_equal(_host(tdq[k]), _host(jdq[k]))
            np.testing.assert_array_equal(terr[k].numpy(),
                                          np.asarray(jerr[k]))


def _capture(monkeypatch, module):
    """Record the grads each train step hands to ``module.opt_mod.apply``
    (returned in the metrics, so a jitted step gives them back)."""
    orig = module.opt_mod.apply

    def apply(cfg, params, grads, state):
        p, s, m = orig(cfg, params, grads, state)
        return p, s, dict(m, grads=grads)

    monkeypatch.setattr(module.opt_mod, "apply", apply)


def test_grad_accum_matches_reference(monkeypatch):
    """grad_accum=4 over a batch of 8: the gradients handed to the
    optimizer are f32 (bf16 parameters too), the mean over microbatches
    of the reference's, and the metrics are the last microbatch's."""
    _capture(monkeypatch, JTS)
    _capture(monkeypatch, TS)
    jcfg, jp, cfg, model = _models("minitron-8b")
    batch = train_batch(cfg, b=8)
    kw = dict(lr=3e-3, warmup_steps=5, total_steps=100)
    jstep = jax.jit(JTS.build_train_step(jcfg, JO.OptConfig(**kw),
                                         grad_accum=4))
    ocfg = O.OptConfig(**kw)
    step = TS.build_train_step(cfg, ocfg, grad_accum=4)
    _, _, jm = jstep(jp, JO.init(JO.OptConfig(**kw), jp), to_jax(batch))
    _, _, tm = step(model, O.init(ocfg, model), to_torch(batch))
    grads = tm.pop("grads")
    assert all(g.dtype == torch.float32 for g in grads.values())
    assert_grads_close(grads, jax_grads_by_path(jm.pop("grads")))
    last = {k: v[6:] for k, v in batch.items()}
    _, want = jax.jit(JTS.loss_and_grads, static_argnums=2)(
        jp, to_jax(last), jcfg)[:2]
    for k in ("loss", "ntokens", "total_loss"):
        _close(tm[k], jm[k])
        _close(tm[k], want[k])
    _close(tm["grad_norm"], jm["grad_norm"])


def test_grad_accum_keeps_f32_grads_for_bf16_params(monkeypatch):
    _capture(monkeypatch, TS)
    _, _, cfg, model = _models("minitron-8b", "bfloat16")
    ocfg = O.OptConfig(lr=3e-3, warmup_steps=5, total_steps=100)
    batch = to_torch(train_batch(cfg, b=4))
    _, _, m = TS.build_train_step(cfg, ocfg, grad_accum=2)(
        model, O.init(ocfg, model), batch)
    assert all(g.dtype == torch.float32 for g in m["grads"].values())
    _, _, m = TS.build_train_step(cfg, ocfg)(model, O.init(ocfg, model),
                                             batch)
    assert m["grads"]["embed.embedding"].dtype == torch.bfloat16


def test_compressed_step_matches_reference(monkeypatch):
    """A compressed step returns the error state; the quantized grads the
    optimizer gets equal the reference's to within its quantization step
    (the f32 grads feeding it differ in their last bits)."""
    _capture(monkeypatch, JTS)
    _capture(monkeypatch, TS)
    jcfg, jp, cfg, model = _models("minitron-8b")
    batch = train_batch(cfg)
    kw = dict(lr=3e-3, warmup_steps=5, total_steps=100)
    jstep = jax.jit(JTS.build_train_step(jcfg, JO.OptConfig(**kw),
                                         compression=True))
    ocfg = O.OptConfig(**kw)
    step = TS.build_train_step(cfg, ocfg, compression=True)
    _, _, jerr, jm = jstep(jp, JO.init(JO.OptConfig(**kw), jp),
                           to_jax(batch), JC.init_error_state(jp))
    out = step(model, O.init(ocfg, model), to_torch(batch),
               C.init_error_state(model))
    assert len(out) == 4
    terr, tm = out[2], out[3]
    want = jax_grads_by_path(jm["grads"])
    werr = jax_grads_by_path(jerr)
    for k, g in tm["grads"].items():
        qstep = float(np.abs(want[k]).max()) / 127
        np.testing.assert_allclose(g.numpy(), want[k], atol=qstep * 1.01,
                                   rtol=0, err_msg=k)
        np.testing.assert_allclose(terr[k].numpy(), werr[k],
                                   atol=qstep * 1.01, rtol=0, err_msg=k)
    with pytest.raises(ValueError, match="error state"):
        step(model, O.init(ocfg, model), to_torch(batch))


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "mamba2-370m",
                                  "seamless-m4t-medium"])
def test_remat_on_equals_off_bit_for_bit(arch):
    """Recomputing every block (or layer) in the backward pass gives the
    gradients of the stored forward, bit for bit."""
    import dataclasses

    _, _, cfg, model = _models(arch)
    batch = to_torch(train_batch(cfg))
    assert cfg.remat_policy != "none"
    on = TS.loss_and_grads(model, batch, cfg)
    off = TS.loss_and_grads(model, batch,
                            dataclasses.replace(cfg, remat_policy="none"))
    assert torch.equal(on[0], off[0])
    for k in on[2]:
        assert torch.equal(on[2][k], off[2][k]), k
