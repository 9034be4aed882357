"""repro_torch's training loop on the CPU: checkpoints (round trip,
corruption, retention, and the on-disk format shared with the JAX
package: a checkpoint either package writes restores in the other, bf16
bits equal), the supervisor (a fault replayed bit for bit, the branch
with no checkpoint, the history trim, its counters), the loss falling
over 30 steps as the reference's test asserts, ``fit`` resuming from its
checkpoints and refusing to start on a missing card, the token
pipeline's law and statelessness, and the prefetcher's order.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import optimizer as JO
from repro.train.checkpoint import Checkpointer as JCheckpointer
from repro_torch.configs import get_smoke_config
from repro_torch.data import tokens as T
from repro_torch.data.pipeline import Prefetcher
from repro_torch.launch.train import fit
from repro_torch.models import model as M
from repro_torch.models.convert import params_from_jax, params_to_numpy
from repro_torch.obs import REGISTRY
from repro_torch.train import optimizer as O
from repro_torch.train.checkpoint import Checkpointer
from repro_torch.train.fault import FaultInjector, Supervisor
from repro_torch.train.train_step import build_train_step
from test_torch_models import _configs, _jparams


def setup(arch="llama3-405b", lr=3e-3, seed=0):
    cfg = get_smoke_config(arch)
    model = M.Model.init(cfg, seed, "cpu")
    ocfg = O.OptConfig(lr=lr, warmup_steps=5, total_steps=100)
    return cfg, ocfg, model, O.init(ocfg, model)


def make_batch_fn(cfg, batch=4, seq=32, seed=0):
    def f(step):
        return T.batch_at_step(seed, step, batch, seq, cfg.vocab_size)
    return f


def _leaves_equal(a, b):
    la, lb = a.reference_leaves(), b.reference_leaves()
    assert list(la) == list(lb)
    return all(torch.equal(la[k], lb[k]) for k in la)


# --------------------------------------------------------------- checkpoints
def test_checkpoint_roundtrip(tmp_path):
    """A bf16 model and its optimizer state restore into fresh templates
    bit for bit, with the step and the extra."""
    cfg, ocfg, model, opt = setup()
    step = build_train_step(cfg, ocfg)
    model, opt, _ = step(model, opt, make_batch_fn(cfg)(0))
    ck = Checkpointer(str(tmp_path))
    ck.save(7, {"params": model, "opt_state": opt}, extra={"note": "x"},
            sync=True)
    _, _, other, other_opt = setup(seed=1)
    assert not _leaves_equal(model, other)
    step_no, state, extra = ck.restore({"params": other,
                                        "opt_state": other_opt})
    assert step_no == 7 and extra == {"note": "x"}
    assert state["params"] is other and _leaves_equal(model, other)
    assert int(other_opt.step) == 1
    for k in opt.mu:
        assert torch.equal(opt.mu[k], other_opt.mu[k])
        assert torch.equal(opt.nu[k], other_opt.nu[k])


def test_checkpoint_detects_corruption(tmp_path):
    _, _, model, _ = setup()
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"params": model}, sync=True)
    target = os.path.join(str(tmp_path), "step_00000001", "params.npz")
    with open(target, "r+b") as f:
        f.seek(100)
        f.write(b"\x00" * 32)
    with pytest.raises(IOError, match="corruption"):
        ck.restore({"params": model})


def test_checkpoint_retention_and_background_writes(tmp_path):
    _, _, model, _ = setup()
    ck = Checkpointer(str(tmp_path), keep_last=2)
    for s in (1, 2, 3, 4):
        ck.save(s, {"params": model})  # on the writer thread
    ck.wait()
    assert ck.all_steps() == [3, 4] and ck.latest_step() == 4
    assert not [n for n in os.listdir(tmp_path) if n.startswith(".tmp")]


def test_background_save_holds_the_pre_step_state(tmp_path, monkeypatch):
    """A save returns before its files are written; the next step updates
    the parameters and the moments in place meanwhile. The writer is held
    until that step is done: the checkpoint still restores the state at
    the save, bit for bit."""
    import threading

    cfg, ocfg, model, opt = setup()
    step = build_train_step(cfg, ocfg)
    model, opt, _ = step(model, opt, make_batch_fn(cfg)(0))
    before = {k: t.clone() for k, t in model.reference_leaves().items()}
    mu = {k: t.clone() for k, t in opt.mu.items()}
    stepped = threading.Event()
    savez = np.savez

    def held_savez(*args, **kwargs):
        assert stepped.wait(60)
        savez(*args, **kwargs)

    monkeypatch.setattr(np, "savez", held_savez)
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"params": model, "opt_state": opt})
    model, opt, _ = step(model, opt, make_batch_fn(cfg)(1))
    stepped.set()
    ck.wait()
    assert not all(torch.equal(before[k], t)
                   for k, t in model.reference_leaves().items())
    _, _, other, other_opt = setup(seed=1)
    ck.restore({"params": other, "opt_state": other_opt})
    for k, t in other.reference_leaves().items():
        assert torch.equal(t, before[k]), k
    for k, t in other_opt.mu.items():
        assert torch.equal(t, mu[k]), k
    assert int(other_opt.step) == 1


def test_checkpoint_refuses_another_shape(tmp_path):
    _, _, model, _ = setup()
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"params": model}, sync=True)
    cfg = get_smoke_config("llama3-405b")
    import dataclasses

    wider = M.Model.init(dataclasses.replace(cfg, d_ff=cfg.d_ff * 2), 0,
                         "cpu")
    with pytest.raises(ValueError, match="template"):
        ck.restore({"params": wider})


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_reference_checkpoint_restores_in_the_port(tmp_path, dtype):
    """The reference's Checkpointer writes params and an AdamW state; the
    port's restores them into its templates: the parameters equal
    params_from_jax of the same tree, bf16 bits included."""
    jcfg, cfg = _configs("gemma2-2b", dtype)
    jp = _jparams(jcfg)
    jo = JO.init(JO.OptConfig(state_dtype=jnp.bfloat16), jp)
    jo = jo._replace(step=jnp.int32(12), mu=jax.tree_util.tree_map(
        lambda p: (p * 0.5).astype(jnp.bfloat16), jp))
    JCheckpointer(str(tmp_path)).save(12, {"params": jp, "opt_state": jo},
                                      extra={"loss": 1.5}, sync=True)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    want = params_from_jax(tree, cfg, "cpu")
    model = M.Model.init(cfg, 3, "cpu")
    opt = O.init(O.OptConfig(state_dtype=torch.bfloat16), model)
    step, _, extra = Checkpointer(str(tmp_path)).restore(
        {"params": model, "opt_state": opt})
    assert step == 12 and extra == {"loss": 1.5} and int(opt.step) == 12
    assert _leaves_equal(model, want)
    mu = jax.tree_util.tree_map(np.asarray, jo.mu)
    for k, t in opt.mu.items():
        node = mu
        for part in k.split("."):
            node = node[part]
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      node.view(np.int16))


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    """The port writes a bf16 model and its optimizer state; the
    reference's Checkpointer restores them into its own templates, the
    parameters bit-equal to params_to_numpy."""
    cfg, ocfg, model, opt = setup("gemma2-2b")
    model, opt, _ = build_train_step(cfg, ocfg)(model, opt,
                                                make_batch_fn(cfg)(0))
    Checkpointer(str(tmp_path)).save(3, {"params": model, "opt_state": opt},
                                     sync=True)
    from repro.configs import get_smoke_config as jget_smoke
    from repro.models import model as JM
    from repro.models.params import initialize

    jcfg = jget_smoke("gemma2-2b")
    jp = initialize(JM.model_specs(jcfg), jax.random.PRNGKey(9))
    jo = JO.init(JO.OptConfig(), jp)
    step, state, _ = JCheckpointer(str(tmp_path)).restore(
        {"params": jp, "opt_state": jo})
    assert step == 3 and int(state["opt_state"].step) == 1
    want = params_to_numpy(model)
    got = jax.tree_util.tree_map(np.asarray, state["params"])
    flat_w = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    for path, g in jax.tree_util.tree_flatten_with_path(got)[0]:
        w = flat_w[path]
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8))
    np.testing.assert_array_equal(
        np.asarray(state["opt_state"].mu["embed"]["embedding"]),
        opt.mu["embed.embedding"].numpy())


# ---------------------------------------------------------------- supervisor
def test_loss_decreases():
    cfg, ocfg, model, opt = setup()
    step = build_train_step(cfg, ocfg)
    mk = make_batch_fn(cfg)
    losses = []
    for i in range(30):
        model, opt, m = step(model, opt, mk(i))
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1, losses


def test_fault_injection_replays_bitwise(tmp_path):
    """Kill at step 12, restart from checkpoint 10: the loss stream
    equals an uninterrupted run's bit for bit (stateless data and a
    deterministic step on the CPU)."""
    before = REGISTRY.counter("train.restarts").value
    cfg, ocfg, model, opt = setup()
    step = build_train_step(cfg, ocfg)
    mk = make_batch_fn(cfg)
    sup = Supervisor(step, mk, Checkpointer(str(tmp_path / "a")),
                     ckpt_every=5, injector=FaultInjector(fail_at=[12]))
    faulty = sup.run(model, opt, 0, 20)
    assert faulty["restarts"] == 1 and faulty["final_step"] == 20
    assert REGISTRY.counter("train.restarts").value == before + 1
    _, _, model2, opt2 = setup()
    clean = Supervisor(step, mk, Checkpointer(str(tmp_path / "b")),
                       ckpt_every=5).run(model2, opt2, 0, 20)
    assert clean["restarts"] == 0
    assert faulty["losses"] == clean["losses"]
    assert _leaves_equal(faulty["params"], clean["params"])


def test_fault_before_any_checkpoint_keeps_the_current_state(tmp_path):
    """With no checkpoint yet the supervisor counts from the start again
    on the state at hand (the reference's branch): the steps before the
    fault are taken twice."""
    cfg, ocfg, model, opt = setup()
    step = build_train_step(cfg, ocfg)
    out = Supervisor(step, make_batch_fn(cfg), Checkpointer(str(tmp_path)),
                     ckpt_every=50, injector=FaultInjector(fail_at=[2])).run(
        model, opt, 0, 4)
    assert out["restarts"] == 1 and len(out["losses"]) == 4
    assert int(out["opt_state"].step) == 6  # 2 steps, then 4 more


def test_history_trim_is_clamped_at_zero(tmp_path):
    """A checkpoint older than start_step (left by an earlier run) is
    restored and replayed as warm-up; the history keeps only this run's
    steps."""
    cfg, ocfg, model, opt = setup()
    step = build_train_step(cfg, ocfg)
    ck = Checkpointer(str(tmp_path))
    ck.save(2, {"params": model, "opt_state": opt}, sync=True)
    out = Supervisor(step, make_batch_fn(cfg), ck, ckpt_every=50,
                     injector=FaultInjector(fail_at=[6])).run(
        model, opt, 5, 3)
    assert out["restarts"] == 1 and out["final_step"] == 8
    assert len(out["losses"]) == 3


# ----------------------------------------------------------------------- fit
def test_fit_resumes_from_its_checkpoints(tmp_path):
    cfg = get_smoke_config("minitron-8b")
    first = fit(cfg, steps=10, batch=2, seq=16, ckpt_dir=str(tmp_path),
                ckpt_every=5, log_every=100, device="cpu")
    assert first["final_step"] == 10 and len(first["losses"]) == 10
    out = fit(cfg, steps=14, batch=2, seq=16, ckpt_dir=str(tmp_path),
              ckpt_every=5, log_every=100, device="cpu")
    assert out["final_step"] == 14
    assert len(out["losses"]) == 4  # resumed at 10


def test_fit_trains_an_encoder_decoder_and_cleans_up(tmp_path, monkeypatch):
    """seamless's frames come from the fit's generator; with no ckpt_dir
    the checkpoints go to a temporary directory that is removed."""
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", None)
    cfg = get_smoke_config("seamless-m4t-medium")
    out = fit(cfg, steps=3, batch=2, seq=8, ckpt_every=2, device="cpu")
    assert out["final_step"] == 3 and all(np.isfinite(out["losses"]))
    assert os.listdir(tmp_path) == []


def test_fit_needs_a_card_unless_asked_for_the_cpu():
    cfg = get_smoke_config("minitron-8b")
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fit(cfg, steps=1, batch=1, seq=4)


# ------------------------------------------------------------------- tokens
def test_batch_at_step_is_a_pure_function_of_seed_step_rows():
    a = T.batch_at_step(0, 5, 4, 32, 512)
    b = T.batch_at_step(0, 5, 4, 32, 512)
    assert set(a) == {"tokens", "labels"}
    assert a["tokens"].shape == (4, 32) and a["tokens"].dtype == torch.int32
    assert torch.equal(a["tokens"], b["tokens"])
    assert torch.equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    assert not torch.equal(a["tokens"], T.batch_at_step(0, 6, 4, 32,
                                                        512)["tokens"])
    assert not torch.equal(a["tokens"], T.batch_at_step(1, 5, 4, 32,
                                                        512)["tokens"])
    part = T.batch_at_step(0, 5, 4, 32, 512, row_start=2, row_count=2)
    assert part["tokens"].shape == (2, 32)
    assert torch.equal(part["tokens"], T.batch_at_step(
        0, 5, 4, 32, 512, row_start=2, row_count=2)["tokens"])
    assert int(a["tokens"].min()) >= 0 and int(a["tokens"].max()) < 512


def test_batch_at_step_follows_the_reference_law():
    """Each position takes its left neighbour's draw with probability 0.5
    (position 0 the last's), so two neighbours are equal with probability
    1/4 + 3/4 q, q the chance that two fresh draws agree; the unigram's
    head frequencies follow the Zipf law of -1.2 log(rank). The
    reference's own batches (drawn from jax keys) show the same rates."""
    from repro.data.tokens import batch_at_step as jbatch_at_step

    def rates(batches):
        toks = np.concatenate([np.asarray(b["tokens"]) for b in batches])
        same = float((toks[:, 1:] == toks[:, :-1]).mean())
        freq = np.bincount(toks.ravel(), minlength=1000) / toks.size
        return same, freq

    p = torch.softmax(T.zipf_logits(1000).double(), 0).numpy()
    want_same = 0.25 + 0.75 * float((p * p).sum())
    ours = rates([T.batch_at_step(3, s, 16, 256, 1000) for s in range(8)])
    theirs = rates([jbatch_at_step(3, s, 16, 256, 1000) for s in range(8)])
    for same, freq in (ours, theirs):
        assert abs(same - want_same) < 0.02
        for r in range(4):
            assert abs(freq[r] - p[r]) < 0.1 * p[r]
        assert freq[0] / freq[1] == pytest.approx(2 ** 1.2, rel=0.1)


def test_zipf_logits_match_reference():
    from repro.data.tokens import _zipf_logits

    np.testing.assert_allclose(T.zipf_logits(300).numpy(),
                               np.asarray(_zipf_logits(300)), rtol=1e-6)


# ----------------------------------------------------------------- prefetch
def test_prefetcher_order_and_skip_ahead():
    calls = []

    def make(step):
        calls.append(step)
        return {"step": torch.tensor(step)}

    pf = Prefetcher(make, start_step=7, prefetch=2)
    got = [next(pf) for _ in range(5)]
    pf.close()
    assert [s for s, _ in got] == [7, 8, 9, 10, 11]
    assert [int(b["step"]) for _, b in got] == [7, 8, 9, 10, 11]
    assert calls[:5] == [7, 8, 9, 10, 11]


def test_prefetcher_hands_a_failure_to_the_consumer():
    def make(step):
        if step == 2:
            raise KeyError("boom")
        return {}

    pf = Prefetcher(make, prefetch=1)
    assert next(pf)[0] == 0 and next(pf)[0] == 1
    with pytest.raises(KeyError):
        next(pf)
    pf.close()
