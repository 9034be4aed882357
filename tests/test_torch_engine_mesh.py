"""repro_torch's engine across ranks (``DistributedEngine(mesh=...)`` over
``torch.distributed``, with ``launch/mesh.py``) against the reference's
shard_map engine, on the reference's own mesh scenarios
(tests/test_distributed.py):

- mesh a: (2, 2) ("data", "model"), shards over ("data",): 2048 x 64
  z-normalised random walks, DSTree leaf_cap 32, 4 queries, k = 5, an
  f32 spill, then one insert and one delete;
- mesh b: (2, 2, 1) ("pod", "data", "model"), shards over ("pod",
  "data"): 1024 x 64 normal rows, iSAX2+ leaf_cap 32, 3 queries, k = 4.

The port runs in one gloo world of 4 rank subprocesses (a FileStore
under the test's tmp directory, so no port can collide); the reference
runs each mesh on 4 forced host devices, one subprocess per mesh, with a
compilation cache under the same directory (its eager shard_map compiles
every operation anew at each query). All six start together, each rank
and mesh writes its answers as ``.npz``, and a subprocess past
``TIMEOUT`` fails the tests instead of stalling the run.

Parity (ROADMAP "Parity rules"): ids equal, distances within DIST_TOL
(the port's f32 sums run in another order than XLA's), leaves_visited,
rows_scanned and lb_computed equal, with and without sync_bsf. Every
rank returns the same answer bit for bit (the model replicas and the
shards alike), out of core equals resident bit for bit, and a mesh
engine equals the one-card engine of as many shards bit for bit, solo
and cooperative (``share_gathers``). The merge's counters
(``engine.mesh_s``, ``engine.gathers``, ``engine.mesh_spread_s``) move
once a gather on every rank, and not at all on one card.
"""

import inspect
import json
import os
import textwrap

import numpy as np
import pytest
import torch
import torch.distributed as dist

import _worlds
from repro_torch import obs
from repro_torch.core import guarantees as G
from repro_torch.core.engine import DistributedEngine
from repro_torch.core.spec import IndexSpec, StoreSpec
from repro_torch.launch import distributed_search
from repro_torch.launch import mesh as M

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 300  # seconds for the whole world, and for each reference mesh
WORLD = 4
GNAMES = ("exact", "eps", "delta_eps", "ng")
PORT_G = {"exact": G.exact(), "eps": G.epsilon(1.0),
          "delta_eps": G.delta_epsilon(0.99, 0.5), "ng": G.ng(4)}
DIST_TOL = dict(rtol=1e-5, atol=1e-4)
FIELDS = (".d", ".i", ".lv", ".rs", ".lb")


def mesh_a_data():
    rng = np.random.default_rng(0)
    data = np.cumsum(rng.normal(size=(2048, 64)), axis=1)
    data = ((data - data.mean(1, keepdims=True))
            / (data.std(1, keepdims=True) + 1e-9)).astype(np.float32)
    q = (data[rng.choice(2048, 4)]
         + 0.05 * rng.normal(size=(4, 64)).astype(np.float32))
    return data, q


def mesh_b_data():
    rng = np.random.default_rng(0)
    data = rng.normal(size=(1024, 64)).astype(np.float32)
    return data, data[:3] + 0.01


# name: (shape, axis names, shard axes, method, leaf_cap, k)
MESHES = {
    "a": ((2, 2), ("data", "model"), ("data",), "dstree", 32, 5),
    "b": ((2, 2, 1), ("pod", "data", "model"), ("pod", "data"), "isax2+",
          32, 4),
}
# the writes of mesh a: three rows in, then the first query's nearest
# row and one of the new rows out
INSERT_IDS = (5000, 5001, 5002)


def write_rows(data):
    return data[:3] * 0.5 + 0.1


# the merge's counters, as obs.REGISTRY.snapshot names them
MESH_COUNTERS = ("engine.mesh_s{part=loop}", "engine.mesh_s{part=gather}",
                 "engine.gathers", "engine.mesh_spread_s")

PRELUDE = "\n".join([
    "import json, os, sys", "import numpy as np",
    f"MESHES = {MESHES!r}", f"GNAMES = {GNAMES!r}",
    f"MESH_COUNTERS = {MESH_COUNTERS!r}",
    f"INSERT_IDS = {INSERT_IDS!r}",
    inspect.getsource(mesh_a_data), inspect.getsource(mesh_b_data),
    inspect.getsource(write_rows),
    "DATA = {'a': mesh_a_data, 'b': mesh_b_data}",
    "res = {}",
    textwrap.dedent("""
        def put(name, r, its=None):
            res[name + '.d'] = np.asarray(r.dists)
            res[name + '.i'] = np.asarray(r.ids)
            res[name + '.lv'] = np.asarray(r.leaves_visited)
            res[name + '.rs'] = np.asarray(r.rows_scanned)
            res[name + '.lb'] = np.asarray(int(r.lb_computed))
            if its is not None:
                res[name + '.it'] = np.asarray(its)
    """)])

PORT_RANK = PRELUDE + textwrap.dedent("""
    import torch.distributed as dist
    from repro_torch.core import guarantees as G
    from repro_torch.core.engine import DistributedEngine
    from repro_torch.core.spec import IndexSpec, StoreSpec
    from repro_torch.launch import mesh as M
    from repro_torch.obs import REGISTRY as REG

    rank, out = int(sys.argv[1]), sys.argv[2]
    M.init_world("cpu", store=dist.FileStore(os.path.join(out, "rdv"), 4),
                 rank=rank, world_size=4)
    GS = {"exact": G.exact(), "eps": G.epsilon(1.0),
          "delta_eps": G.delta_epsilon(0.99, 0.5), "ng": G.ng(4)}
    for multi in (False, True):
        try:
            M.make_production_mesh(multi_pod=multi, device="cpu")
            res[f"prod.{int(multi)}"] = np.asarray("")
        except ValueError as e:
            res[f"prod.{int(multi)}"] = np.asarray(str(e))
    for m, (shape, names, axes, method, cap, k) in MESHES.items():
        data, q = DATA[m]()
        mesh = M.make_test_mesh(shape, names, device="cpu")
        res[m + ".sizes"] = np.asarray(json.dumps(M.mesh_axis_sizes(mesh)))
        res[m + ".data_axes"] = np.asarray(json.dumps(M.data_axes(mesh)))
        eng = DistributedEngine(mesh=mesh, axes=axes, method=method,
                                device="cpu")
        eng.build(data, index=IndexSpec(method, leaf_cap=cap),
                  store=StoreSpec(spill_dir=os.path.join(out, "spill_" + m)))
        lay = eng._layout
        res[m + ".layout"] = np.asarray([lay.index, lay.count, lay.writer])
        res[m + ".shard_dirs"] = np.asarray(eng.shard_dirs)
        for g in GNAMES:
            for sync in (0, 1):
                r = eng.query(q, k, GS[g], sync_bsf=bool(sync))
                put(f"{m}.{g}.{sync}", r, r.iterations)
            r = eng.query(q, k, GS[g], ooc=True)
            put(f"{m}.{g}.ooc", r, r.iterations)
        # cooperative, each guarantee with and without lockstep; the
        # merge's counters over these queries alone
        before = REG.snapshot("engine.")
        for g in GNAMES:
            for sync in (0, 1):
                r = eng.query(q, k, GS[g], sync_bsf=bool(sync),
                              share_gathers=True)
                put(f"{m}.{g}.{sync}.coop", r, r.iterations)
        after = REG.snapshot("engine.")
        for c in MESH_COUNTERS:
            res[f"{m}.counter.{c}"] = np.asarray(
                after.get(c, 0) - before.get(c, 0), dtype=np.float64)
        if m == "a":
            eng.insert(write_rows(data), ids=np.asarray(INSERT_IDS))
            eng.delete(np.asarray([int(res["a.exact.0.i"][0, 0]),
                                   INSERT_IDS[1]]))
            for g in ("exact", "eps"):
                put(f"a.{g}.mut", eng.query(q, k, GS[g]))
            res["a.compacted"] = np.asarray(eng.compact())
            put("a.exact.compacted", eng.query(q, k, GS["exact"]))
            res["a.seg_dir"] = np.asarray(eng._seg_dir)
        eng.close()
        # a build that keeps no shard on the device serves out of core
        eng = DistributedEngine(mesh=mesh, axes=axes, method=method,
                                device="cpu")
        eng.build(data, index=IndexSpec(method, leaf_cap=cap),
                  store=StoreSpec(spill_dir=os.path.join(out, "only_" + m),
                                  keep_resident=False))
        r = eng.query(q, k, GS["exact"])
        put(f"{m}.exact.spilled", r, r.iterations)
        eng.close()
    np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
    M.destroy_world()
""")

REFERENCE = PRELUDE + textwrap.dedent("""
    import jax
    from repro.core import IndexSpec, StoreSpec
    from repro.core import guarantees as JG
    from repro.core.engine import DistributedEngine
    from repro.launch import mesh as M

    m, out = sys.argv[1], sys.argv[2]
    jax.config.update("jax_compilation_cache_dir",
                      os.path.join(out, "jax_cache_" + m))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    GS = {"exact": JG.exact(), "eps": JG.epsilon(1.0),
          "delta_eps": JG.delta_epsilon(0.99, 0.5), "ng": JG.ng(4)}
    if m == "a":
        for multi in (False, True):
            try:
                M.make_production_mesh(multi_pod=multi)
                res[f"prod.{int(multi)}"] = np.asarray("")
            except Exception as e:  # noqa: BLE001 recorded: any refusal counts
                res[f"prod.{int(multi)}"] = np.asarray(type(e).__name__)
    shape, names, axes, method, cap, k = MESHES[m]
    data, q = DATA[m]()
    mesh = M.make_test_mesh(shape, names)
    res[m + ".sizes"] = np.asarray(json.dumps(
        {a: int(s) for a, s in M.mesh_axis_sizes(mesh).items()}))
    res[m + ".data_axes"] = np.asarray(json.dumps(M.data_axes(mesh)))
    eng = DistributedEngine(mesh, axes=axes, method=method)
    eng.build(data, index=IndexSpec(method, leaf_cap=cap),
              store=StoreSpec(spill_dir=os.path.join(out, "ref_spill_" + m)))
    for g in GNAMES:
        for sync in (0, 1):
            put(f"{m}.{g}.{sync}", eng.query(q, k, GS[g],
                                             sync_bsf=bool(sync)))
    if m == "a":
        eng.insert(write_rows(data), ids=np.asarray(INSERT_IDS))
        eng.delete(np.asarray([int(res["a.exact.0.i"][0, 0]),
                               INSERT_IDS[1]]))
        for g in ("exact", "eps"):
            put(f"a.{g}.mut", eng.query(q, k, GS[g]))
    np.savez(os.path.join(out, f"ref_{m}.npz"), **res)
""")


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """Starts the port's world and the reference's meshes together;
    returns (directory, {name: Popen}, {name: log path})."""
    out = str(tmp_path_factory.mktemp("mesh"))
    src = os.path.join(REPO, "src")
    port_env = dict(os.environ, PYTHONPATH=src, OMP_NUM_THREADS="1")
    ref_env = dict(os.environ, PYTHONPATH=src, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=4")
    jobs = {f"rank{r}": ([PORT_RANK, str(r)], port_env)
            for r in range(WORLD)}
    jobs.update({f"ref_{m}": ([REFERENCE, m], ref_env) for m in MESHES})
    procs, logs = _worlds.start(jobs, out)
    yield out, procs, logs
    _worlds.stop(procs)


@pytest.fixture(scope="module")
def port_world(launched):
    """Each rank's answers, by rank."""
    out, procs, logs = launched
    ranks = {n: p for n, p in procs.items() if n.startswith("rank")}
    _worlds.run_all(ranks, logs, TIMEOUT)
    return [dict(np.load(os.path.join(out, f"rank{r}.npz")))
            for r in range(WORLD)]


@pytest.fixture(scope="module")
def reference(launched):
    """The reference's answers, by mesh, and its spill directory."""
    out, procs, logs = launched
    _worlds.run_all({n: p for n, p in procs.items()
                     if n.startswith("ref")}, logs, TIMEOUT)
    return {m: dict(np.load(os.path.join(out, f"ref_{m}.npz")))
            for m in MESHES}, out


def _parity(got: dict, want: dict, key: str, lb: bool = True) -> None:
    np.testing.assert_array_equal(got[key + ".i"], want[key + ".i"])
    np.testing.assert_allclose(got[key + ".d"], want[key + ".d"], **DIST_TOL)
    np.testing.assert_array_equal(got[key + ".lv"], want[key + ".lv"])
    np.testing.assert_array_equal(got[key + ".rs"], want[key + ".rs"])
    if lb:
        assert int(got[key + ".lb"]) == int(want[key + ".lb"])


# ------------------------------------------------------------ the mesh
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_mesh_sizes_and_data_axes_equal_the_reference(port_world, reference,
                                                      mesh):
    ref, _ = reference
    for r in range(WORLD):
        got = port_world[r]
        assert json.loads(str(got[mesh + ".sizes"])) == json.loads(
            str(ref[mesh][mesh + ".sizes"]))
        assert json.loads(str(got[mesh + ".data_axes"])) == json.loads(
            str(ref[mesh][mesh + ".data_axes"]))


@pytest.mark.parametrize("multi", [0, 1], ids=["single_pod", "multi_pod"])
def test_production_mesh_raises_at_world_4(port_world, reference, multi):
    ref, _ = reference
    want = "512" if multi else "256"
    for r in range(WORLD):
        msg = str(port_world[r][f"prod.{multi}"])
        assert f"needs {want} ranks; the world has 4" in msg
    assert str(ref["a"][f"prod.{multi}"]) != ""


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_shard_layout_is_row_major_with_one_writer_per_shard(port_world,
                                                             mesh):
    shape, names, axes, *_ = MESHES[mesh]
    coords = np.stack(np.unravel_index(np.arange(WORLD), shape), 1)
    sizes = [shape[names.index(a)] for a in axes]
    writers = []
    for r in range(WORLD):
        index, count, writer = port_world[r][mesh + ".layout"].tolist()
        want = int(np.ravel_multi_index(
            [coords[r][names.index(a)] for a in axes], sizes))
        assert (index, count) == (want, int(np.prod(sizes)))
        off = [coords[r][i] for i, a in enumerate(names) if a not in axes]
        assert bool(writer) == (not any(off))
        if writer:
            writers.append(index)
    assert sorted(writers) == list(range(int(np.prod(sizes))))


# ------------------------------------------------------ against the reference
@pytest.mark.parametrize("mesh,gname,sync", [
    (m, g, s) for m in sorted(MESHES) for g in GNAMES for s in (0, 1)])
def test_resident_query_matches_the_reference(port_world, reference, mesh,
                                              gname, sync):
    ref, _ = reference
    _parity(port_world[0], ref[mesh], f"{mesh}.{gname}.{sync}")


@pytest.mark.parametrize("gname", ["exact", "eps"])
def test_write_tier_matches_the_reference(port_world, reference, gname):
    """One insert of three rows and one delete (a base row and a new
    row), the same writes on every rank of the port and on the
    reference's engine."""
    ref, _ = reference
    _parity(port_world[0], ref["a"], f"a.{gname}.mut")


@pytest.mark.parametrize("gname", GNAMES)
def test_port_serves_the_reference_mesh_spill(reference, gname):
    """The reference's mesh build spills its two shards; the port's
    mesh-free open_spill serves them as the reference's mesh answers."""
    ref, out = reference
    _, q = mesh_a_data()
    eng = DistributedEngine.open_spill(
        StoreSpec(spill_dir=os.path.join(out, "ref_spill_a"),
                  keep_resident=False), device="cpu")
    try:
        assert eng.n_shards == 2
        r = eng.query(q, 5, PORT_G[gname])
    finally:
        eng.close()
    got = {}
    for f, v in zip(FIELDS, (r.dists, r.ids, r.leaves_visited,
                             r.rows_scanned, r.lb_computed)):
        got[f"x{f}"] = np.asarray(v)
    want = {f"x{f}": ref["a"][f"a.{gname}.0{f}"] for f in FIELDS}
    _parity(got, want, "x")


# --------------------------------------------------------- within the port
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_every_rank_returns_the_same_answer(port_world, mesh):
    """The model replicas, and every shard's rank, hold the merged answer
    bit for bit, visit counts and iterations included."""
    keys = [k for k in port_world[0] if k.startswith(mesh + ".")
            and k.rsplit(".", 1)[1] in ("d", "i", "lv", "rs", "lb", "it")]
    assert len(keys) >= 4 * 3 * 6  # guarantees x (plain, sync, ooc) x fields
    for r in range(1, WORLD):
        for key in keys:
            np.testing.assert_array_equal(port_world[r][key],
                                          port_world[0][key], err_msg=key)


@pytest.mark.parametrize("mesh,gname", [
    (m, g) for m in sorted(MESHES) for g in GNAMES])
def test_resident_equals_out_of_core_bit_for_bit(port_world, mesh, gname):
    """Answers, visit counts and iterations; lb_computed counts a resident
    shard padded to the widest shard's leaves and a store at its own (the
    reference's two paths differ alike), so it is held to that."""
    got = port_world[0]
    for f in (".d", ".i", ".lv", ".rs", ".it"):
        np.testing.assert_array_equal(got[f"{mesh}.{gname}.ooc{f}"],
                                      got[f"{mesh}.{gname}.0{f}"])
    assert int(got[f"{mesh}.{gname}.ooc.lb"]) <= int(got[f"{mesh}.{gname}.0.lb"])


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_a_build_kept_on_disk_serves_out_of_core(port_world, mesh):
    """``keep_resident=False``: no shard on the device, every query out of
    core, the resident engine's exact answer and visits."""
    got = port_world[0]
    for f in (".d", ".i", ".lv", ".rs", ".it"):
        np.testing.assert_array_equal(got[f"{mesh}.exact.spilled{f}"],
                                      got[f"{mesh}.exact.0{f}"])


@pytest.mark.parametrize("mesh,gname,sync,share", [
    pytest.param(m, g, s, share, id=f"{m}-{g}-{s}" + ("-coop" if share
                                                     else ""))
    for m in sorted(MESHES) for g in GNAMES for s in (0, 1)
    for share in (False, True)])
def test_mesh_equals_the_one_card_engine(port_world, mesh, gname, sync,
                                         share):
    """A mesh engine of S shards answers as the one-card engine with
    ``shards=S`` does, bit for bit: the same shards, padded alike, the
    same lockstep, the same merge; solo, and cooperative
    (``share_gathers``: each shard's rows scored against every lane)."""
    shape, names, axes, method, cap, k = MESHES[mesh]
    data, q = (mesh_a_data if mesh == "a" else mesh_b_data)()
    n = int(np.prod([shape[names.index(a)] for a in axes]))
    eng = DistributedEngine(shards=n, method=method, device="cpu")
    eng.build(data, index=IndexSpec(method, leaf_cap=cap))
    r = eng.query(q, k, PORT_G[gname], sync_bsf=bool(sync),
                  share_gathers=share)
    key = f"{mesh}.{gname}.{sync}" + (".coop" if share else "")
    got = port_world[0]
    assert torch.equal(r.dists, torch.as_tensor(got[key + ".d"]))
    assert torch.equal(r.ids, torch.as_tensor(got[key + ".i"]))
    assert torch.equal(r.leaves_visited, torch.as_tensor(got[key + ".lv"]))
    assert torch.equal(r.rows_scanned, torch.as_tensor(got[key + ".rs"]))
    assert r.lb_computed == int(got[key + ".lb"])
    assert list(r.iterations) == got[key + ".it"].tolist()


@pytest.mark.parametrize("case", ["a", "b", "one_card"])
def test_the_merge_counters(port_world, case):
    """Over the cooperative queries of a mesh (four guarantees, with and
    without lockstep): one gather a query on every rank, the rank's own
    loop and the gather's wait both positive, and the spread of the
    shards' loop times, gathered with the answers, at least 0 and the
    same on every rank of a shard group. The one-card engine (no mesh,
    as every single-card cell runs it) leaves every merge counter where
    it was."""
    if case == "one_card":
        data, q = mesh_a_data()
        eng = DistributedEngine(shards=2, device="cpu")
        eng.build(data, index=IndexSpec("dstree", leaf_cap=32))
        before = obs.REGISTRY.snapshot("engine.")
        eng.query(q, 5, PORT_G["ng"], share_gathers=True)
        eng.query(q, 5, PORT_G["ng"], sync_bsf=True)
        after = obs.REGISTRY.snapshot("engine.")
        for c in MESH_COUNTERS:
            assert after.get(c, 0) == before.get(c, 0), c
        return
    got = [{c: float(port_world[r][f"{case}.counter.{c}"])
            for c in MESH_COUNTERS} for r in range(WORLD)]
    queries = 2 * len(GNAMES)
    for g in got:
        assert g["engine.gathers"] == queries
        assert g["engine.mesh_s{part=loop}"] > 0
        assert g["engine.mesh_s{part=gather}"] > 0
        assert g["engine.mesh_spread_s"] >= 0
    # the same on every rank of a shard group (the ranks that share the
    # coordinates off the shard axes): whole microseconds, summed onto
    # totals that differ by group, so equal to a nanosecond
    shape, names, axes, *_ = MESHES[case]
    coords = np.stack(np.unravel_index(np.arange(WORLD), shape), 1)
    first = {}
    for r in range(WORLD):
        off = tuple(int(coords[r][i]) for i, a in enumerate(names)
                    if a not in axes)
        want = first.setdefault(off, got[r]["engine.mesh_spread_s"])
        assert got[r]["engine.mesh_spread_s"] == pytest.approx(want,
                                                               abs=1e-9)


def test_spill_written_once_per_shard(port_world, launched):
    out, _, _ = launched
    spill = os.path.join(out, "spill_a")
    want = [os.path.join(spill, f"shard_{si:04d}") for si in range(2)]
    assert sorted(d for d in os.listdir(spill)
                  if d.startswith("shard_")) == ["shard_0000", "shard_0001"]
    assert not os.path.exists(os.path.join(spill, "replicas"))
    for r in range(WORLD):
        assert port_world[r]["a.shard_dirs"].tolist() == want


def test_each_rank_compacts_into_its_own_writer_dir(port_world, launched):
    """After the writes each rank compacts its copy of the write tier:
    four writer directories, one segment each, and the same exact
    answer as before the compaction."""
    out, _, _ = launched
    seg_root = os.path.join(out, "spill_a", "segments")
    dirs = [str(port_world[r]["a.seg_dir"]) for r in range(WORLD)]
    assert len(set(dirs)) == WORLD
    assert sorted(os.listdir(seg_root)) == sorted(
        os.path.basename(d) for d in dirs)
    for r in range(WORLD):
        assert bool(port_world[r]["a.compacted"])
        assert os.listdir(dirs[r]) == ["seg_0000"]
        for f in (".d", ".i"):
            np.testing.assert_array_equal(
                port_world[r]["a.exact.compacted" + f],
                port_world[r]["a.exact.mut" + f])


# ------------------------------------------------ in this process, world 1
@pytest.fixture
def world_of_one(tmp_path):
    M.init_world("cpu", store=dist.FileStore(str(tmp_path / "rdv"), 1),
                 rank=0, world_size=1)
    try:
        yield
    finally:
        M.destroy_world()


@pytest.mark.parametrize("gname", GNAMES)
def test_world_of_one_equals_the_one_card_engine(world_of_one, gname):
    data, q = mesh_a_data()
    mesh = M.make_test_mesh((1, 1), ("data", "model"), device="cpu")
    eng = DistributedEngine(mesh=mesh, axes=("data",), device="cpu")
    eng.build(data, index=IndexSpec("dstree", leaf_cap=32))
    one = DistributedEngine(shards=1, device="cpu")
    one.build(data, index=IndexSpec("dstree", leaf_cap=32))
    for sync in (False, True):
        a = eng.query(q, 5, PORT_G[gname], sync_bsf=sync)
        b = one.query(q, 5, PORT_G[gname], sync_bsf=sync)
        for x, y in zip(a[:4], b[:4]):
            assert torch.equal(x, y)
        assert (a.lb_computed, a.iterations) == (b.lb_computed, b.iterations)


def test_world_of_one_traces_its_collectives(world_of_one):
    """On a mesh, the lockstep step's all_reduce is an engine.sync_bsf
    span whose flag is one host read a step, and the answers' all_gather
    an engine.gather_results span with two (the counts copied up, the
    tails read back)."""
    data, q = mesh_a_data()
    mesh = M.make_test_mesh((1, 1), ("data", "model"), device="cpu")
    eng = DistributedEngine(mesh=mesh, axes=("data",), device="cpu")
    eng.build(data, index=IndexSpec("dstree", leaf_cap=32))
    sites = {s: obs.REGISTRY.counter("search.host_reads", site=s)
             for s in ("mesh_flag", "mesh_gather", "settle")}
    before = {s: c.value for s, c in sites.items()}
    obs.clear()
    obs.enable()
    try:
        out = eng.query(q, 5, PORT_G["ng"], sync_bsf=True, visit_batch=2)
        names = [sp.name for sp in obs.tracer().spans()]
    finally:
        obs.disable()
        obs.clear()
    got = {s: c.value - before[s] for s, c in sites.items()}
    steps = names.count("engine.sync_bsf")
    # one more step than the shard's settles: the one that finds none
    assert steps == out.iterations[0] + 1 == got["settle"] + 1
    assert got == {"mesh_flag": steps, "mesh_gather": 2,
                   "settle": out.iterations[0]}
    assert names.count("engine.gather_results") == 1


def test_the_engine_runs_where_its_mesh_runs(world_of_one):
    mesh = M.make_test_mesh((1, 1), ("data", "model"), device="cpu")
    assert DistributedEngine(mesh=mesh, device="cpu").device == \
        torch.device("cpu")
    # no card: resolving cuda raises; with one, the mesh's cpu refuses it
    with pytest.raises((RuntimeError, ValueError)):
        DistributedEngine(mesh=mesh, device="cuda")
    assert M.init_world("cpu") == torch.device("cpu")  # the world that is up


def test_distributed_search_at_world_one(capsys):
    distributed_search.main(["--device", "cpu", "--backend", "gloo",
                             "--n-series", "2048", "--series-len", "64",
                             "--leaf-cap", "32"])
    out = capsys.readouterr().out
    assert "ranks: 1, mesh {'data': 1, 'model': 1} on cpu (gloo)" in out
    assert "exact    MAP=1.000" in out
    assert out.rstrip().endswith(
        "ok — sharded exact search matches the single-node brute force")
    assert not dist.is_initialized()


# ------------------------------------------------------------- no card here
def _mesh_on_cuda():
    M.make_test_mesh((1, 1), ("data", "model"), device="cuda")


@pytest.mark.parametrize("call", [
    lambda: M.init_world("cuda"),
    _mesh_on_cuda,
    lambda: M.make_production_mesh(device="cuda"),
    lambda: distributed_search.main([]),
], ids=["init_world", "make_test_mesh", "make_production_mesh",
        "distributed_search"])
def test_cuda_without_a_card_raises(call):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA device"):
        call()
    assert not dist.is_initialized()


def test_a_backend_must_drive_its_device(capsys):
    with pytest.raises(SystemExit):
        distributed_search.main(["--device", "cpu", "--backend", "nccl"])
    assert "a world on cpu runs gloo, not nccl" in capsys.readouterr().err
    assert not dist.is_initialized()
