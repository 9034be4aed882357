"""repro_torch's training across ranks (``launch/sharding``,
``models/sharding_utils``, the train step on DTensors, ``fit(mesh=)``)
against the reference's sharded train step, on a (2, 2) ("data",
"model") mesh.

The port runs in one gloo world of 4 rank subprocesses (a FileStore
under the test's tmp directory, one OMP thread a rank). The reference's
own ``fit(mesh=)`` fails under jax 0.9 (ROADMAP Queue 3), so its sharded
step is composed from its own functions: ``mesh_rules``,
``params.shardings``, ``opt_shardings`` and ``build_train_step`` under
``jax.jit(in_shardings=(psh, osh, None), out_shardings=(psh, osh,
None))`` on an Auto (2, 2) mesh of 4 forced host devices (one
subprocess, a compilation cache under tmp). Both start together from
the reference's f32 weights of the smoke configs of minitron-8b,
deepseek-moe-16b and mamba2-370m (drawn here, carried to the port by
``params_from_jax``) and take 3 AdamW steps on the same batches of 4 x 16
tokens; the reference also takes the steps on one device.

Tolerances (f32; the port's reductions run in another order than XLA's:
the Partial sums, the global norm, the loss mean):

- the loss and the gradient norm of every step: rtol 1e-5 (measured at
  most 1.2e-6 relative, mamba2's gradient norm against the reference's
  one-device step; the losses at most 2.6e-7);
- the moments, which are linear (mu) and quadratic (nu) in the
  gradients: atol 1e-4 times the leaf's largest magnitude (measured at
  most 1.9e-5 of it, mamba2's dt_bias against the port's one rank);
- the parameters: atol 5e-4 = lr / 2 (measured at most 1.04e-4, mamba2's
  embedding against the reference's one-device step). AdamW divides by
  sqrt(nu) + eps: at a gradient near 0 a rounding of 1e-9 in the
  gradient moves the update by up to lr·1e-9/eps = lr/10 a step; the
  moments above hold the gradients themselves tightly;
- with int8 compression (``ef_quantize``) a gradient element at a
  rounding boundary of its code lands one code (max|g| / 127) away: the
  moments at atol 2/127 of the leaf's largest magnitude (measured 2.0e-3
  of it), the parameters as above.

On the world against the port's one rank: the same tolerances, and the
MoE config's routed ids equal. Within the world: ``sequence_parallel``
equals its absence within them too (measured: the losses bit for bit,
the moments within 6.4e-6 of the leaf's largest magnitude); replicas
bit-identical; each rank's shard of every parameter and moment exactly
the size its resolved spec gives; a fault at step 3 replays bit for bit,
with a ``ckpt_dir`` and without one;
checkpoints cross between the world and one rank (and the reference)
bit for bit; ``compressed_psum`` on the reference test's input equals
the reference's ``shard_map`` output sliced on the host, bit for bit,
and within its 0.02 of the true sum.
"""

import dataclasses
import inspect
import os
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _worlds
from repro.models.params import initialize as jinitialize
from repro.train.checkpoint import Checkpointer as JCheckpointer
from repro_torch.configs import get_smoke_config
from repro_torch.launch import sharding as SH
from repro_torch.launch.train import fit
from repro_torch.models import model as M
from repro_torch.models.convert import params_from_jax
from repro_torch.train import optimizer as O
from repro_torch.train.checkpoint import Checkpointer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 400  # seconds for the world, and for the reference
WORLD = 4
SIZES = {"data": 2, "model": 2}
ARCHS = ("minitron-8b", "deepseek-moe-16b", "mamba2-370m")
STEPS, B, S = 3, 4, 16
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
LOSS_TOL = dict(rtol=1e-5, atol=0)
MOMENT_TOL = 1e-4  # times the leaf's largest magnitude
# with compression: one int8 code of a gradient (max|g| / 127) apart
QUANT_TOL = 2 / 127  # times the leaf's largest magnitude
PARAM_TOL = dict(atol=5e-4, rtol=0)
# fit: 4 steps, a checkpoint every 2; the faulted run fails at step 3
FIT = dict(steps=4, batch=B, seq=S, seed=3, ckpt_every=2)
FAULT_AT = 3


def step_batch(vocab, i):
    r = np.random.default_rng(100 + i)
    toks = r.integers(0, vocab, (B, S)).astype(np.int32)
    return {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}


def load_tree(path):
    """The npz of '/'-joined paths as nested dicts of numpy arrays, once
    the reference has written it."""
    import time

    while not os.path.exists(path):
        time.sleep(0.1)
    out = {}
    with np.load(path) as z:
        for key in z.files:
            node = out
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = z[key]
    return out


PRELUDE = "\n".join([
    "import dataclasses, os, sys", "import numpy as np",
    f"ARCHS = {ARCHS!r}", f"STEPS, B, S = {STEPS}, {B}, {S}",
    f"OPT = {OPT!r}", f"FIT = {FIT!r}", f"FAULT_AT = {FAULT_AT}",
    inspect.getsource(step_batch), inspect.getsource(load_tree),
    "res = {}"])

PORT_RANK = PRELUDE + textwrap.dedent("""
    import torch
    torch.set_num_threads(1)
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch.configs import get_smoke_config
    from repro_torch.fault import FaultInjector
    from repro_torch.launch import mesh as MESH
    from repro_torch.launch import sharding as SH
    from repro_torch.launch.train import batch_rows, fit
    from repro_torch.models import model as M
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as tfm
    from repro_torch.models.convert import params_from_jax
    from repro_torch.models import sharding_utils as SU
    from repro_torch.models.sharding_utils import use_mesh
    from repro_torch.train import compress as C
    from repro_torch.train import optimizer as O
    from repro_torch.train.checkpoint import Checkpointer
    from repro_torch.train.train_step import build_train_step

    rank, out = int(sys.argv[1]), sys.argv[2]
    MESH.init_world("cpu", store=dist.FileStore(os.path.join(out, "rdv"),
                                                4), rank=rank, world_size=4)
    mesh = MESH.make_test_mesh((2, 2), ("data", "model"), device="cpu")
    ocfg = O.OptConfig(**OPT)

    def f32(arch, **over):
        return dataclasses.replace(get_smoke_config(arch),
                                   param_dtype=torch.float32,
                                   compute_dtype=torch.float32, **over)

    def dbatch(b):
        start, rows, pl = batch_rows(mesh, B)
        return {k: DTensor.from_local(torch.as_tensor(v[start:start + rows]),
                                      mesh, pl) for k, v in b.items()}

    def put_state(tag, model, st):
        groups = {"p": model.reference_leaves(), "mu": st.mu, "nu": st.nu}
        for g, leaves in groups.items():
            for k, v in leaves.items():
                loc = v.to_local()
                res[f"{tag}.{g}.local.{k}"] = loc.numpy().copy()
                res[f"{tag}.{g}.bytes.{k}"] = np.asarray(
                    loc.untyped_storage().nbytes())
                full = v.full_tensor()
                if rank == 0:
                    res[f"{tag}.{g}.full.{k}"] = full.numpy()

    routed, streams = [], []
    real_route = moe_mod._route
    real_sublayer = tfm._apply_sublayer

    def recording_sublayer(p, x, *args, **kw):
        streams.append(str(tuple(x.placements)))
        return real_sublayer(p, x, *args, **kw)

    def recording_route(logits, cfg):
        w, idx, aux = real_route(logits, cfg)
        routed.append(idx.full_tensor() if isinstance(idx, DTensor)
                      else idx)
        return w, idx, aux

    runs = [(a, f32(a)) for a in ARCHS]
    runs.append(("minitron-8b.sp", f32("minitron-8b",
                                       sequence_parallel=True)))
    for tag, cfg in runs:
        arch = tag.split(".")[0]
        model = params_from_jax(load_tree(os.path.join(out, arch + ".npz")),
                                cfg, "cpu")
        SH.distribute_params(model, mesh, SH.param_shardings(cfg, mesh))
        st = O.init(ocfg, model)
        step = build_train_step(cfg, ocfg)
        moe_mod._route = recording_route
        tfm._apply_sublayer = recording_sublayer
        for i in range(STEPS):
            with use_mesh(mesh):
                _, st, m = step(model, st, dbatch(step_batch(
                    cfg.vocab_size, i)))
            moe_mod._route = real_route
            tfm._apply_sublayer = real_sublayer
            res[f"{tag}.loss.{i}"] = float(m["loss"])
            res[f"{tag}.gnorm.{i}"] = float(m["grad_norm"])
        if routed:
            res[f"{tag}.routed"] = torch.stack(routed).numpy()
            routed.clear()
        res[f"{tag}.streams"] = np.asarray(sorted(set(streams)))
        streams.clear()
        put_state(tag, model, st)

    # grad_accum and compression on sharded leaves
    cfg = f32("minitron-8b")
    for tag, kw in (("accum", dict(grad_accum=2)),
                    ("compress", dict(compression=True))):
        model = params_from_jax(load_tree(os.path.join(out,
                                                       "minitron-8b.npz")),
                                cfg, "cpu")
        SH.distribute_params(model, mesh, SH.param_shardings(cfg, mesh))
        st = O.init(ocfg, model)
        step = build_train_step(cfg, ocfg, **kw)
        err = C.init_error_state(model) if tag == "compress" else None
        for i in range(2):
            with use_mesh(mesh):
                if err is None:
                    _, st, m = step(model, st, dbatch(step_batch(
                        cfg.vocab_size, i)))
                else:
                    _, st, err, m = step(model, st, dbatch(step_batch(
                        cfg.vocab_size, i)), err)
            res[f"{tag}.loss.{i}"] = float(m["loss"])
        put_state(tag, model, st)

    # fit on the mesh, clean and with a fault at FAULT_AT; "scratch"
    # without a ckpt_dir (rank 0's temporary directory)
    for tag, inj in (("fit", None), ("fault", FaultInjector({FAULT_AT})),
                     ("scratch", FaultInjector({FAULT_AT}))):
        where = (dict(ckpt_dir=os.path.join(out, "ckpt_" + tag))
                 if tag != "scratch" else {})
        r = fit(cfg, mesh=mesh, device="cpu", injector=inj, **where, **FIT)
        res[f"{tag}.losses"] = np.asarray(r["losses"])
        res[f"{tag}.restarts"] = np.asarray(r["restarts"])
        res[f"{tag}.final_step"] = np.asarray(r["final_step"])
        put_state(tag, r["params"], r["opt_state"])

    # a checkpoint written on one rank, restored on the world
    ck = Checkpointer(os.path.join(out, "ckpt_one"))
    model = M.Model.init(cfg, 0, "cpu")
    tmpl = {"params": model, "opt_state": O.init(ocfg, model)}
    step_at, got, _ = ck.restore(
        tmpl, shardings={"params": SH.param_shardings(cfg, mesh),
                         "opt_state": SH.opt_shardings(cfg, ocfg, mesh)},
        mesh=mesh)
    res["one.step"] = np.asarray(step_at)
    put_state("one", got["params"], got["opt_state"])

    # compressed_psum over all four ranks: the reference test's input,
    # one row a rank
    x = torch.arange(32, dtype=torch.float32).reshape(4, 8) / 7.0
    res["psum"] = C.compressed_psum(x[rank:rank + 1],
                                    SU.flat_group(mesh)).numpy()
    res["psum.data"] = C.compressed_psum(x[rank:rank + 1],
                                         mesh["data"]).numpy()

    res["coord"] = np.asarray(mesh.get_coordinate())
    np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
    MESH.destroy_world()
""")

REFERENCE = PRELUDE + textwrap.dedent("""
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType, PartitionSpec as P
    from repro.compat import shard_map
    from repro.configs import get_smoke_config
    from repro.launch import sharding as shard_lib
    from repro.models import model as JM
    from repro.models import params as params_mod
    from repro.train import compress as JC
    from repro.train import optimizer as JO
    from repro.train.train_step import build_train_step

    out = sys.argv[2]
    jax.config.update("jax_compilation_cache_dir",
                      os.path.join(out, "jax_cache"))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    ocfg = JO.OptConfig(**OPT)

    def f32(arch):
        return dataclasses.replace(get_smoke_config(arch),
                                   param_dtype=jnp.float32,
                                   compute_dtype=jnp.float32)

    # the weights first: the port's ranks wait for them
    for arch in ARCHS:
        jp = params_mod.initialize(JM.model_specs(f32(arch)),
                                   jax.random.PRNGKey(0))
        flat = jax.tree_util.tree_flatten_with_path(jp)[0]
        np.savez(os.path.join(out, arch + ".tmp.npz"),
                 **{"/".join(str(k.key) for k in path): np.asarray(v)
                    for path, v in flat})
        os.rename(os.path.join(out, arch + ".tmp.npz"),
                  os.path.join(out, arch + ".npz"))

    def flat(tree, prefix):
        for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
            key = ".".join(str(getattr(p, "key", getattr(p, "name", p)))
                           for p in path)
            res[prefix + "." + key] = np.asarray(v)

    for arch in ARCHS:
        cfg = f32(arch)
        params = jax.tree_util.tree_map(
            jnp.asarray, load_tree(os.path.join(out, arch + ".npz")))
        rules = shard_lib.mesh_rules(mesh)
        psh = params_mod.shardings(JM.model_specs(cfg), rules, mesh)
        osh = shard_lib.opt_shardings(cfg, ocfg, mesh, rules)
        step = build_train_step(cfg, ocfg)
        runs = {"mesh": (jax.jit(step, in_shardings=(psh, osh, None),
                                 out_shardings=(psh, osh, None)),
                         jax.device_put(params, psh),
                         jax.device_put(JO.init(ocfg, params), osh)),
                "one": (jax.jit(step), params, JO.init(ocfg, params))}
        for kind, (fn, p, o) in runs.items():
            for i in range(STEPS):
                p, o, m = fn(p, o, {k: jnp.asarray(v) for k, v in
                                    step_batch(cfg.vocab_size, i).items()})
                res[f"{kind}.{arch}.loss.{i}"] = float(m["loss"])
                res[f"{kind}.{arch}.gnorm.{i}"] = float(m["grad_norm"])
            flat(p, f"{kind}.{arch}.p")
            flat(o.mu, f"{kind}.{arch}.mu")
            flat(o.nu, f"{kind}.{arch}.nu")

    # the reference's compressed_psum test, its output sliced on the host
    pmesh = jax.make_mesh((4,), ("pod",))
    x = jnp.arange(32, dtype=jnp.float32).reshape(4, 8) / 7.0
    y = shard_map(lambda xs: JC.compressed_psum(xs, "pod"), mesh=pmesh,
                  in_specs=P("pod"), out_specs=P("pod"))(x)
    res["psum"] = np.asarray(y)
    np.savez(os.path.join(out, "ref.npz"), **res)
""")


def _f32(arch, **over):
    return dataclasses.replace(get_smoke_config(arch),
                               param_dtype=torch.float32,
                               compute_dtype=torch.float32, **over)


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """Writes a one-rank checkpoint, then starts the port's world and the
    reference together (the reference draws the weights first, which the
    ranks wait for); returns (directory, {name: Popen}, {name: log
    path})."""
    out = str(tmp_path_factory.mktemp("train_mesh"))
    # one rank: two steps of fit, the checkpoint the world restores
    fit(_f32("minitron-8b"), steps=2, batch=B, seq=S, seed=5, ckpt_every=2,
        ckpt_dir=os.path.join(out, "ckpt_one"), device="cpu")
    src = os.path.join(REPO, "src")
    port_env = dict(os.environ, PYTHONPATH=src, OMP_NUM_THREADS="1")
    ref_env = dict(os.environ, PYTHONPATH=src, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=4")
    jobs = {f"rank{r}": ([PORT_RANK, str(r)], port_env)
            for r in range(WORLD)}
    jobs["ref"] = ([REFERENCE, "ref"], ref_env)
    procs, logs = _worlds.start(jobs, out)
    yield out, procs, logs
    _worlds.stop(procs)


@pytest.fixture(scope="module")
def world(launched):
    """Each rank's results, by rank, and the directory."""
    out, procs, logs = launched
    _worlds.run_all({n: p for n, p in procs.items()
                     if n.startswith("rank")}, logs, TIMEOUT)
    return [dict(np.load(os.path.join(out, f"rank{r}.npz")))
            for r in range(WORLD)], out


@pytest.fixture(scope="module")
def reference(launched):
    out, procs, logs = launched
    _worlds.run_all({"ref": procs["ref"]}, logs, TIMEOUT)
    return dict(np.load(os.path.join(out, "ref.npz")))


def _leaves(res, tag, group):
    pre = f"{tag}.{group}.full."
    return {k[len(pre):]: v for k, v in res.items() if k.startswith(pre)}


def _assert_state_close(got, want_of, tag, want_tag, moment_tol=MOMENT_TOL):
    """The port's full parameters and moments against another run's."""
    for group in ("p", "mu", "nu"):
        g = _leaves(got, tag, group)
        w = want_of(want_tag, group)
        assert sorted(g) == sorted(w), group
        for k, v in g.items():
            if group == "p":
                np.testing.assert_allclose(v, w[k], err_msg=k, **PARAM_TOL)
            else:
                scale = float(np.abs(w[k]).max())
                np.testing.assert_allclose(
                    v, w[k], rtol=0, atol=moment_tol * max(scale, 1e-30),
                    err_msg=f"{group} {k}")


def _ref_state(ref):
    def of(tag, group):
        pre = f"{tag}.{group}."
        return {k[len(pre):]: v for k, v in ref.items() if k.startswith(pre)}
    return of


# ------------------------------------------------- against the reference
@pytest.mark.parametrize("kind", ["mesh", "one"])
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_matches_reference(world, reference, arch, kind):
    """Three steps: losses, gradient norms, then every parameter and
    moment, against the reference's sharded step (``mesh``) and its
    one-device step (``one``)."""
    res = world[0][0]
    for i in range(STEPS):
        np.testing.assert_allclose(res[f"{arch}.loss.{i}"],
                                   reference[f"{kind}.{arch}.loss.{i}"],
                                   **LOSS_TOL)
        np.testing.assert_allclose(res[f"{arch}.gnorm.{i}"],
                                   reference[f"{kind}.{arch}.gnorm.{i}"],
                                   **LOSS_TOL)
    _assert_state_close(res, _ref_state(reference), arch, f"{kind}.{arch}")


def test_reference_sharded_step_matches_its_one_device_step(reference):
    """The reference against itself, for scale: its sharded and one-device
    steps differ by reduction order too."""
    for arch in ARCHS:
        for i in range(STEPS):
            np.testing.assert_allclose(reference[f"mesh.{arch}.loss.{i}"],
                                       reference[f"one.{arch}.loss.{i}"],
                                       **LOSS_TOL)


# ------------------------------------------------- against the port's one rank
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_matches_one_rank(world, arch):
    from repro_torch.models import moe as moe_mod
    from repro_torch.train.train_step import build_train_step

    res, out = world[0][0], world[1]
    cfg = _f32(arch)
    model = params_from_jax(load_tree(os.path.join(out, arch + ".npz")),
                            cfg, "cpu")
    ocfg = O.OptConfig(**OPT)
    st = O.init(ocfg, model)
    step = build_train_step(cfg, ocfg)
    routed, real = [], moe_mod._route

    def recording(logits, c):
        w, idx, aux = real(logits, c)
        routed.append(idx)
        return w, idx, aux

    moe_mod._route = recording
    try:
        for i in range(STEPS):
            batch = {k: torch.as_tensor(v) for k, v in
                     step_batch(cfg.vocab_size, i).items()}
            _, st, m = step(model, st, batch)
            moe_mod._route = real
            np.testing.assert_allclose(res[f"{arch}.loss.{i}"],
                                       float(m["loss"]), **LOSS_TOL)
    finally:
        moe_mod._route = real
    if cfg.moe is not None:
        assert routed
        np.testing.assert_array_equal(res[f"{arch}.routed"],
                                      torch.stack(routed).numpy())
    leaves = model.reference_leaves()

    def of(_, group):
        src = leaves if group == "p" else getattr(st, group)
        return {k: v.numpy() for k, v in src.items()}

    _assert_state_close(res, of, arch, None)


def test_sequence_parallel_equals_its_absence_on_the_world(world):
    res = world[0][0]
    for i in range(STEPS):
        np.testing.assert_allclose(res[f"minitron-8b.sp.loss.{i}"],
                                   res[f"minitron-8b.loss.{i}"], **LOSS_TOL)

    def of(_, group):
        return _leaves(res, "minitron-8b", group)

    _assert_state_close(res, of, "minitron-8b.sp", None)
    # the residual stream entering every sub-layer: split over 'data' by
    # rows, and under sequence parallelism over 'model' by positions
    assert res["minitron-8b.streams"].tolist() == [
        "(Shard(dim=0), Replicate())"]
    assert res["minitron-8b.sp.streams"].tolist() == [
        "(Shard(dim=0), Shard(dim=1))"]


@pytest.mark.parametrize("tag", ["accum", "compress"])
def test_grad_accum_and_compression_on_sharded_leaves(world, tag):
    from repro_torch.train import compress as C
    from repro_torch.train.train_step import build_train_step

    res, out = world[0][0], world[1]
    cfg = _f32("minitron-8b")
    model = params_from_jax(load_tree(os.path.join(out,
                                                   "minitron-8b.npz")),
                            cfg, "cpu")
    ocfg = O.OptConfig(**OPT)
    st = O.init(ocfg, model)
    kw = dict(grad_accum=2) if tag == "accum" else dict(compression=True)
    step = build_train_step(cfg, ocfg, **kw)
    err = C.init_error_state(model) if tag == "compress" else None
    for i in range(2):
        batch = {k: torch.as_tensor(v) for k, v in
                 step_batch(cfg.vocab_size, i).items()}
        if err is None:
            _, st, m = step(model, st, batch)
        else:
            _, st, err, m = step(model, st, batch, err)
        np.testing.assert_allclose(res[f"{tag}.loss.{i}"], float(m["loss"]),
                                   **LOSS_TOL)
    leaves = model.reference_leaves()

    def of(_, group):
        src = leaves if group == "p" else getattr(st, group)
        return {k: v.numpy() for k, v in src.items()}

    _assert_state_close(res, of, tag, None,
                        QUANT_TOL if tag == "compress" else MOMENT_TOL)


# ------------------------------------------------------------ layout
def _runs():
    return [(a, a) for a in ARCHS] + [("minitron-8b", "minitron-8b.sp"),
                                      ("minitron-8b", "fit"),
                                      ("minitron-8b", "one")]


@pytest.mark.parametrize("arch,tag", _runs(), ids=[t for _, t in _runs()])
def test_each_rank_holds_only_its_shards(world, arch, tag):
    """Every parameter and both moments: a rank's shard has exactly the
    elements (and the storage bytes) its resolved spec leaves it."""
    ranks = world[0]
    specs = SH.by_path(SH.param_pspecs(_f32(arch), SIZES))
    for r in range(WORLD):
        for group in ("p", "mu", "nu"):
            pre = f"{tag}.{group}.local."
            locs = {k[len(pre):]: v for k, v in ranks[r].items()
                    if k.startswith(pre)}
            assert sorted(locs) == sorted(specs)
            for k, loc in locs.items():
                full = ranks[0][f"{tag}.{group}.full.{k}"]
                split = 1
                for e in specs[k]:
                    for a in ((e,) if isinstance(e, str) else e or ()):
                        split *= SIZES[a]
                assert loc.size * split == full.size, (r, group, k)
                assert int(ranks[r][f"{tag}.{group}.bytes.{k}"]) == \
                    loc.nbytes, (r, group, k)
    # some leaves are split four ways: fsdp over 'data' and TP over 'model'
    assert any(loc.size * 4 == ranks[0][k.replace(".local.", ".full.")].size
               for k, loc in ranks[0].items() if f"{tag}.p.local." in k)


@pytest.mark.parametrize("arch,tag", _runs(), ids=[t for _, t in _runs()])
def test_replicas_are_bit_identical_across_ranks(world, arch, tag):
    """Ranks that hold the same shard of a leaf hold the same bits, and
    the shards put together are the whole leaf."""
    ranks = world[0]
    specs = SH.by_path(SH.param_pspecs(_f32(arch), SIZES))
    names = list(SIZES)
    for group in ("p", "mu", "nu"):
        for k, spec in specs.items():
            used = {a for e in spec
                    for a in ((e,) if isinstance(e, str) else e or ())}
            seen = {}
            for r in range(WORLD):
                coord = ranks[r]["coord"]
                key = tuple(int(c) for n, c in zip(names, coord)
                            if n in used)
                loc = ranks[r][f"{tag}.{group}.local.{k}"]
                if key in seen:
                    assert seen[key].tobytes() == loc.tobytes(), (group, k)
                seen[key] = loc


# ------------------------------------------------------------ fit
def test_fit_on_the_mesh_equals_one_rank_fit(world, tmp_path):
    res = world[0][0]
    one = fit(_f32("minitron-8b"), device="cpu",
              ckpt_dir=str(tmp_path / "one"), **FIT)
    np.testing.assert_allclose(res["fit.losses"], np.asarray(one["losses"]),
                               **LOSS_TOL)
    leaves = one["params"].reference_leaves()

    def of(_, group):
        src = leaves if group == "p" else getattr(one["opt_state"], group)
        return {k: v.numpy() for k, v in src.items()}

    _assert_state_close(res, of, "fit", None)


def _assert_replayed(world, tag):
    for r in range(WORLD):
        res = world[0][r]
        assert int(res[f"{tag}.restarts"]) == 1
        assert int(res[f"{tag}.final_step"]) == FIT["steps"]
        np.testing.assert_array_equal(res[f"{tag}.losses"], res["fit.losses"])
        for group in ("p", "mu", "nu"):
            pre = f"fit.{group}.local."
            for k in (k for k in res if k.startswith(pre)):
                assert res[k].tobytes() == res[k.replace(
                    "fit.", tag + ".", 1)].tobytes(), k


def test_fault_replays_bit_for_bit_on_the_world(world):
    _assert_replayed(world, "fault")


def test_fault_replays_bit_for_bit_without_a_ckpt_dir(world):
    """Without a ckpt_dir every rank restores from rank 0's temporary
    directory, not from a directory of its own that only rank 0 fills."""
    _assert_replayed(world, "scratch")


# ------------------------------------------------------------ checkpoints
def test_world_checkpoint_restores_on_one_rank_and_in_the_reference(world):
    from repro.configs import get_smoke_config as jget_smoke
    from repro.models import model as JM
    from repro.train import optimizer as JO

    res, out = world[0][0], world[1]
    ck = Checkpointer(os.path.join(out, "ckpt_fit"))
    assert ck.latest_step() == FIT["steps"]
    cfg = _f32("minitron-8b")
    model = M.Model.init(cfg, 0, "cpu")
    tmpl = {"params": model, "opt_state": O.init(O.OptConfig(), model)}
    step, got, _ = ck.restore(tmpl)
    assert step == FIT["steps"]
    for k, v in got["params"].reference_leaves().items():
        assert v.numpy().tobytes() == res[f"fit.p.full.{k}"].tobytes(), k
    for k, v in got["opt_state"].mu.items():
        assert v.numpy().tobytes() == res[f"fit.mu.full.{k}"].tobytes(), k
    # the reference reads the same files
    jcfg = dataclasses.replace(jget_smoke("minitron-8b"),
                               param_dtype=jnp.float32,
                               compute_dtype=jnp.float32)
    jp = jinitialize(JM.model_specs(jcfg), jax.random.PRNGKey(1))
    _, jst, _ = JCheckpointer(os.path.join(out, "ckpt_fit")).restore(
        {"params": jp, "opt_state": JO.init(JO.OptConfig(), jp)})
    flat = jax.tree_util.tree_flatten_with_path(jst["params"])[0]
    for path, v in flat:
        k = ".".join(str(p.key) for p in path)
        assert np.asarray(v).tobytes() == res[f"fit.p.full.{k}"].tobytes()


def test_one_rank_checkpoint_restores_on_the_world(world):
    res, out = world[0][0], world[1]
    ck = Checkpointer(os.path.join(out, "ckpt_one"))
    cfg = _f32("minitron-8b")
    model = M.Model.init(cfg, 9, "cpu")
    tmpl = {"params": model, "opt_state": O.init(O.OptConfig(**OPT), model)}
    step, got, _ = ck.restore(tmpl)
    assert int(res["one.step"]) == step == 2
    for k, v in got["params"].reference_leaves().items():
        assert v.numpy().tobytes() == res[f"one.p.full.{k}"].tobytes(), k
    for k, v in got["opt_state"].nu.items():
        assert v.numpy().tobytes() == res[f"one.nu.full.{k}"].tobytes(), k


# ------------------------------------------------------------ compressed_psum
def test_compressed_psum_matches_the_reference_sliced_on_the_host(world,
                                                                   reference):
    x = np.arange(32, dtype=np.float32).reshape(4, 8) / 7.0
    true = x.sum(axis=0, keepdims=True)
    want = reference["psum"]  # [4, 8], every row the same sum
    for r in range(WORLD):
        got = world[0][r]["psum"]
        assert got.shape == (1, 8) and got.dtype == np.float32
        np.testing.assert_array_equal(got, want[:1])
        np.testing.assert_array_equal(got, want[r:r + 1])
        rel = float(np.abs(got - true).max()) / float(np.abs(true).max())
        assert rel < 0.02
        # over 'data' alone: the two rows of this rank's data column
        coord = world[0][r]["coord"]
        rows = [2 * d + int(coord[1]) for d in range(2)]
        part = x[rows].sum(axis=0, keepdims=True)
        got = world[0][r]["psum.data"]
        assert float(np.abs(got - part).max()) / float(
            np.abs(part).max()) < 0.02
