"""repro_torch's training loss and its gradients against the JAX
package's, on the CPU: ``layers.cross_entropy`` with a mask and the
z-loss, then ``model.loss_fn`` and every gradient leaf of
``train_step.loss_and_grads`` against ``jax.value_and_grad(loss_fn)`` on
the smoke configs of six families, f32, with the reference's weights
carried over by ``params_from_jax``; and the rule that a parameter the
loss does not use gets zeros (seamless's top-level ``final_norm``).

Tolerances: the loss and the metrics at atol = rtol = 1e-4; a gradient
leaf at atol = 1e-4 times the leaf's largest magnitude and rtol = 1e-4
(measured: at most 1.5e-5 of the leaf's largest magnitude, on jamba).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro.models import model as JM
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.train import optimizer as O
from repro_torch.train.train_step import loss_and_grads
from test_torch_models import _close, _models

ARCHS = ["minitron-8b", "gemma2-2b", "deepseek-moe-16b", "mamba2-370m",
         "jamba-v0.1-52b", "seamless-m4t-medium"]
B, S = 2, 16


def train_batch(cfg, b=B, s=S, seed=1):
    """numpy tokens, labels (the tokens rolled by one) and, for an
    encoder-decoder, frames."""
    r = np.random.default_rng(seed)
    toks = r.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    if cfg.is_encdec:
        batch["frames"] = r.normal(
            size=(b, cfg.encoder_frames, cfg.d_model)).astype(np.float32)
    return batch


def to_torch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def jax_grads_by_path(tree):
    """The reference's gradient tree as {dotted path: numpy}."""
    return {".".join(str(p.key) for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def assert_grads_close(got, want):
    assert list(got) == sorted(want, key=lambda p: p.split("."))
    for path, g in got.items():
        w = want[path]
        assert tuple(g.shape) == w.shape, path
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(g.float().numpy(), w,
                                   atol=1e-4 * max(scale, 1e-30), rtol=1e-4,
                                   err_msg=path)


_jvg = jax.jit(jax.value_and_grad(JM.loss_fn, has_aux=True),
               static_argnums=2)


# ------------------------------------------------------------ cross entropy
@pytest.mark.parametrize("masked,z", [(False, 0.0), (True, 0.0),
                                      (True, 1e-3)])
def test_cross_entropy_matches_reference(masked, z):
    r = np.random.default_rng(0)
    logits = (r.normal(size=(3, 7, 50)) * 4).astype(np.float32)
    labels = r.integers(0, 50, (3, 7)).astype(np.int32)
    mask = (r.random((3, 7)) < 0.6).astype(np.float32) if masked else None
    want, wm = JL.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                None if mask is None else jnp.asarray(mask),
                                z_loss=z)
    got, gm = L.cross_entropy(torch.as_tensor(logits),
                              torch.as_tensor(labels),
                              None if mask is None else torch.as_tensor(mask),
                              z_loss=z)
    _close(got, want)
    assert set(gm) == set(wm) == {"loss", "ntokens", "ppl_proxy"}
    for k in wm:
        _close(gm[k], wm[k])


def test_cross_entropy_takes_bf16_logits_in_f32_and_an_empty_mask():
    r = np.random.default_rng(1)
    logits = jnp.asarray(r.normal(size=(2, 5, 30)) * 8, jnp.bfloat16)
    labels = r.integers(0, 30, (2, 5)).astype(np.int32)
    t_logits = torch.as_tensor(np.array(logits.astype(jnp.float32))).to(
        torch.bfloat16)
    want, _ = JL.cross_entropy(logits, jnp.asarray(labels))
    got, _ = L.cross_entropy(t_logits, torch.as_tensor(labels))
    assert got.dtype == torch.float32
    _close(got, want)
    zero = np.zeros((2, 5), np.float32)  # denominator max(0, 1): loss 0
    got, gm = L.cross_entropy(t_logits, torch.as_tensor(labels),
                              torch.as_tensor(zero))
    assert float(got) == 0.0 and float(gm["ntokens"]) == 0.0


# --------------------------------------------------------- loss and grads
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_reference(arch):
    """loss_fn's total (cross entropy plus the MoE loss) and metrics, and
    every gradient leaf in the reference's stacked layout and order."""
    jcfg, jp, cfg, model = _models(arch)
    batch = train_batch(cfg)
    (jl, jm), jg = _jvg(jp, to_jax(batch), jcfg)
    loss, metrics, grads = loss_and_grads(model, to_torch(batch), cfg)
    _close(loss, jl)
    assert set(metrics) == set(jm)
    for k in jm:
        _close(metrics[k], jm[k])
    if cfg.moe is not None:
        assert float(metrics["moe_loss"]) > 0
    assert_grads_close(grads, jax_grads_by_path(jg))
    # the model's parameters are left as they were: frozen, no .grad
    assert not any(p.requires_grad or p.grad is not None
                   for p in model.parameters())


def test_loss_fn_matches_reference_with_a_mask():
    jcfg, jp, cfg, model = _models("minitron-8b")
    batch = train_batch(cfg)
    batch["mask"] = (np.arange(S)[None, :] < np.array([[5], [16]])).astype(
        np.float32)
    want, wm = jax.jit(JM.loss_fn, static_argnums=2)(jp, to_jax(batch), jcfg)
    got, gm = M.loss_fn(model, to_torch(batch), cfg)
    _close(got, want)
    assert float(gm["ntokens"]) == 21.0


def test_unused_parameter_gets_zero_gradient():
    """seamless's decoder ends in dec_norm: final_norm is in no path to
    the loss. Its gradient is zeros of its dtype, as jax's, and it takes
    the weight decay of an AdamW step as the reference's apply gives it."""
    jcfg, jp, cfg, model = _models("seamless-m4t-medium")
    batch = train_batch(cfg)
    _, _, grads = loss_and_grads(model, to_torch(batch), cfg)
    g = grads["final_norm.scale"]
    assert g.dtype == torch.float32 and not g.any()
    (_, _), jg = _jvg(jp, to_jax(batch), jcfg)
    assert not np.asarray(jg["final_norm"]["scale"]).any()

    from repro.train import optimizer as JO

    with torch.no_grad():
        model.final_norm.scale.fill_(0.5)
    jp = dict(jp, final_norm={"scale": jnp.full((cfg.d_model,), 0.5)})
    ocfg = O.OptConfig(lr=1e-2, warmup_steps=1, total_steps=10)
    _, _, _ = O.apply(ocfg, model, grads, O.init(ocfg, model))
    want, _, _ = JO.apply(JO.OptConfig(lr=1e-2, warmup_steps=1,
                                       total_steps=10), jp, jg,
                          JO.init(JO.OptConfig(), jp))
    _close(model.final_norm.scale, want["final_norm"]["scale"])
    assert float(model.final_norm.scale[0]) < 0.5


def test_ssd_gradient_stays_finite_where_the_masked_decay_overflows():
    """Strong decay (cum_i - cum_j above 88 for i < j): the port masks
    the intra-chunk exponent before exp, so its forward equals the
    reference's and its gradient equals the sequential oracle's, while
    the reference's gradient (exp first, then the mask) is NaN."""
    from repro.models import ssm as JS
    from repro_torch.models import ssm as TS_

    r = np.random.default_rng(7)
    b, s, h, n, p = 1, 32, 2, 4, 3
    x = r.normal(size=(b, s, h, p)).astype(np.float32)
    bb = r.normal(size=(b, s, h, n)).astype(np.float32)
    cc = r.normal(size=(b, s, h, n)).astype(np.float32)
    dt = np.full((b, s, h), 10.0, np.float32)
    a = np.array([-2.0, -0.5], np.float32)  # up to 15 x 20 = 300 a chunk

    def port(fn):
        ts = [torch.tensor(v, requires_grad=True) for v in (x, bb, cc, dt)]
        y, _ = fn(*ts, torch.tensor(a), *([16] if fn is TS_.ssd_chunked
                                          else []))
        y.square().sum().backward()
        return y.detach(), [t.grad for t in ts]

    y, grads = port(TS_.ssd_chunked)
    y_ref, grads_ref = port(TS_.ssd_reference)
    torch.testing.assert_close(y, y_ref, atol=1e-4, rtol=1e-4)
    for g, w in zip(grads, grads_ref):
        assert bool(torch.isfinite(g).all())
        torch.testing.assert_close(g, w, atol=1e-3, rtol=1e-3)
    jy, _ = JS.ssd_chunked(*map(jnp.asarray, (x, bb, cc, dt, a)), 16)
    _close(y, jy)
    jg = jax.grad(lambda *t: jnp.sum(jnp.square(
        JS.ssd_chunked(*t, jnp.asarray(a), 16)[0])), argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, (x, bb, cc, dt)))
    assert not all(bool(jnp.isfinite(g).all()) for g in jg)
