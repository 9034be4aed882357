"""repro_torch's dry run at the production meshes (launch/dryrun.py,
launch/dryrun_search.py and launch/roofline.py over a dry world) against
the JAX package.

Every world here is a dry one (``launch/mesh.init_dry_world``: torch's
``fake`` backend, this process rank 0), brought up in-process and torn
down by the ``dry`` fixture, so that no later test in the same worker
sees a world.

* The collective recorder on the reference's own
  ``tests/test_distributed.py::test_roofline_parser_on_real_hlo``:
  ``(x @ w).sum()`` with x split over 'data' and w over 'model' on a
  (4, 2) world, its answer whole on every rank as jit's is.
* ``OpCount`` and ``LiveBytes`` read one rank's operations and bytes on
  a sharded matmul of known shapes.
* ``lower_cell`` at the reference's two oracle cells
  (``test_reduced_dryrun_cell_compiles_multipod`` and
  ``test_decode_cell_compiles``): its analytic terms ``==`` the
  reference's ``analytic`` and ``model_flops`` at world 8, called here.
  The collective counts are printed, not held to GSPMD's. The train cell's
  sequence is cut from 4096 to ``SEQ_CUT`` for time only: the uncut
  cell takes ~90 s on the host (``scripts/dryrun_oracle_torch.py`` runs
  both cells uncut; PERF.md §6 has their reports).
* ``parallelism="fsdp"`` and ``donate=False`` on the decode cell.
* ``lower_search`` on a mesh against the reference's ``lower_search`` on
  8 host devices (one subprocess, started with the module: the
  reference's dryrun modules set XLA_FLAGS to 512 host devices on
  import), and its one all-gather a query batch.
* ``main --mesh both`` of both modules writes both directories.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path
from unittest import mock

import pytest
import torch

from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_smoke_config as j_get_smoke_config
from repro.launch import analytic as j_analytic
from repro.launch import roofline as j_roofline
from repro_torch import configs
from repro_torch.launch import dryrun, dryrun_search
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import roofline

ROOT = Path(__file__).resolve().parent.parent
# the train oracle cell's sequence, cut from train_4k's 4096 for time only
SEQ_CUT = 512
JAMBA = dict(grad_accum=2, arch_overrides={"attn_dense_threshold": 8192})
SEARCH = dict(n_per_shard=8192, series_len=64, batch=8, k=10, nprobe=4,
              visit_batch=2)

REF_SEARCH = """
import json, sys
import numpy as np
import jax
from jax.sharding import Mesh
import repro.launch.dryrun_search as ds

mesh = Mesh(np.array(jax.devices()[:8]).reshape(4, 2), ("data", "model"))
with mesh:
    rep = ds.lower_search(mesh, **SEARCH)
print("RESULT " + json.dumps({k: rep[k] for k in (
    "world", "flops_per_device", "bytes_per_device", "n_total_series",
    "terms_seconds", "note", "model_flops_global")}))
"""


@pytest.fixture(scope="module", autouse=True)
def reference_search():
    """The reference's search cell on a (4, 2) mesh of 8 host devices, in
    a subprocess started with the module."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    script = f"SEARCH = {SEARCH!r}\n" + textwrap.dedent(REF_SEARCH)
    proc = subprocess.Popen([sys.executable, "-c", script], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture
def dry():
    """make(shape, axes) -> a mesh over a dry world; the world is torn
    down after the test."""
    def make(shape, axes):
        return mesh_mod.init_dry_world(shape, axes)

    yield make
    mesh_mod.destroy_world()


@pytest.fixture
def smoke_configs():
    with mock.patch.object(dryrun, "get_config", configs.get_smoke_config):
        yield


def _sharded(shape, dtype, mesh, placements):
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(torch.empty(shape, dtype=dtype, device="meta"),
                             mesh, placements, src_data_rank=None)


def test_recorder_on_the_reference_parser_case(dry):
    from torch.distributed.tensor import Replicate, Shard

    mesh = dry((4, 2), ("data", "model"))
    x = _sharded((64, 32), torch.bfloat16, mesh, [Shard(0), Replicate()])
    w = _sharded((32, 16), torch.bfloat16, mesh, [Replicate(), Shard(1)])
    with roofline.CollectiveRecorder() as rec:
        (x @ w).sum().full_tensor()
    ops = roofline.parse_collectives(rec.records, 8)
    print("collectives:", [(o.op, o.bytes_result, o.group_size) for o in ops])
    assert len(ops) > 0
    assert all(o.wire_bytes >= 0 and o.group_size >= 1 for o in ops)
    assert "all-reduce" in {o.op for o in ops}
    assert {o.op for o in ops} <= set(roofline.KINDS)


def test_counts_are_one_ranks_on_a_sharded_matmul(dry):
    from torch.distributed.tensor import Replicate, Shard

    mesh = dry((4, 2), ("data", "model"))
    m, k, n = 64, 4096, 512
    x = _sharded((m, k), torch.float32, mesh, [Shard(0), Replicate()])
    w = _sharded((k, n), torch.float32, mesh, [Replicate(), Shard(1)])
    # a DTensor's own storage reports the whole tensor's bytes
    assert x.untyped_storage().nbytes() == m * k * 4
    flops, live = dryrun.OpCount(), dryrun.LiveBytes([x, w])
    with flops, live:
        y = x @ w
        out = live.new_bytes([y])
    assert tuple(y.to_local().shape) == (m // 4, n // 2)
    assert flops.total == 2 * m * k * n // 8
    assert out == live.peak == (m // 4) * (n // 2) * 4
    assert dryrun._tree_bytes([x, w]) == (m // 4 * k + k * n // 2) * 4


def _want(arch, shape, accum=1, **over):
    """The reference's analytic terms and model flops for the cell at
    world 8, as its dryrun.lower_cell computes them."""
    jcfg = j_get_smoke_config(arch)
    if over:
        jcfg = dataclasses.replace(jcfg, **over)
    remat = shape.kind == "train" and jcfg.remat_policy == "nothing_saveable"
    af = j_analytic.flops_model(jcfg, shape, grad_accum=accum,
                                remat=remat)["flops_global"]
    ab = j_analytic.bytes_model(jcfg, shape, param_count=jcfg.param_count(),
                                grad_accum=accum, opt_bytes_per_param=8,
                                remat=remat)["bytes_global"]
    mf = j_roofline.model_flops(jcfg, shape, jcfg.active_param_count())
    return {"flops_per_device": af / 8, "bytes_per_device": ab / 8,
            "model_flops_global": mf,
            "useful_flops_ratio": (mf / 8) / (af / 8)}


def _check(rep, want, mesh_shape):
    assert rep["status"] == "ok"
    assert rep["world"] == 8 and rep["mesh"] == list(mesh_shape)
    for key, value in want.items():
        assert rep[key] == value, key
    assert rep["n_collectives"] > 0
    assert rep["wire_bytes_per_device"] > 0
    assert rep["terms_seconds"]["collective"] == (
        rep["wire_bytes_per_device"] / roofline.NVLINK_BW)
    assert set(rep["wire_bytes_by_kind"]) <= set(roofline.KINDS)
    m = rep["memory_analysis"]
    assert m["argument_bytes"] > 0 and m["temp_bytes"] > 0
    assert m["live_bytes"] == (m["argument_bytes"] + m["output_bytes"]
                               + m["temp_bytes"])
    print(rep["arch"], rep["shape"], rep["mesh"], rep["parallelism"],
          "collectives", rep["n_collectives"], rep["wire_bytes_by_kind"],
          rep["note"])


def test_train_oracle_cell_on_the_pod_mesh(dry, smoke_configs):
    """jamba smoke, train_4k (its sequence cut to SEQ_CUT), grad_accum 2,
    dense attention up to 8192, on (2, 2, 2) (pod, data, model)."""
    mesh = dry((2, 2, 2), ("pod", "data", "model"))
    shapes = dict(configs.SHAPES)
    shapes["train_4k"] = dataclasses.replace(shapes["train_4k"], seq=SEQ_CUT)
    with mock.patch.object(dryrun, "SHAPES", shapes):
        rep = dryrun.lower_cell("jamba-v0.1-52b", "train_4k", mesh, **JAMBA)
    jsh = dataclasses.replace(J_SHAPES["train_4k"], seq=SEQ_CUT)
    _check(rep, _want("jamba-v0.1-52b", jsh, 2, attn_dense_threshold=8192),
           (2, 2, 2))
    assert rep["mesh_axes"] == ["pod", "data", "model"]
    assert "accumulated step whole" in rep["note"]


@pytest.fixture
def decode_mesh(dry, smoke_configs):
    return dry((4, 2), ("data", "model"))


def test_decode_oracle_cell(decode_mesh):
    """gemma2-2b smoke, decode_32k, on (4, 2) (data, model)."""
    rep = dryrun.lower_cell("gemma2-2b", "decode_32k", decode_mesh)
    _check(rep, _want("gemma2-2b", J_SHAPES["decode_32k"]), (4, 2))
    assert rep["mesh_axes"] == ["data", "model"]
    fit = dryrun.fits_hbm("gemma2-2b", "decode_32k", decode_mesh)
    m = rep["memory_analysis"]
    assert fit == {"fits_hbm": m["fits_hbm"], "live_bytes": m["live_bytes"]}


def test_fsdp_lays_nothing_over_model(decode_mesh):
    from torch.distributed.tensor import Replicate

    rep = dryrun.lower_cell("gemma2-2b", "decode_32k", decode_mesh,
                            parallelism="fsdp")
    _check(rep, _want("gemma2-2b", J_SHAPES["decode_32k"]), (4, 2))
    assert rep["parallelism"] == "fsdp"
    rules, acts = dryrun._parallelism(decode_mesh, "fsdp", None)
    assert rules["batch"] == rules["fsdp"] == ("data", "model")
    assert acts["heads"] == ()
    cell = dryrun._cell("gemma2-2b", "decode_32k", None, None, decode_mesh,
                        None, "fsdp")
    # every parameter and the cache: no dim split over 'model' alone
    model_dim = decode_mesh.mesh_dim_names.index("model")
    for t in list(cell.arguments[0].parameters()) + list(
            roofline.tensors(cell.arguments[1]["cache"])):
        p = t.placements[model_dim]
        assert isinstance(p, Replicate) or p == t.placements[0], p
    with pytest.raises(ValueError):
        dryrun.lower_cell("gemma2-2b", "decode_32k", decode_mesh,
                          parallelism="pp")


def test_without_donation_the_new_cache_is_an_output(decode_mesh):
    kept = dryrun.lower_cell("gemma2-2b", "decode_32k", decode_mesh)
    new = dryrun.lower_cell("gemma2-2b", "decode_32k", decode_mesh,
                            donate=False)
    cell = dryrun._cell("gemma2-2b", "decode_32k", None, None, decode_mesh)
    cache = dryrun._tree_bytes(cell.arguments[1]["cache"])
    assert cache > 0
    mk, mn = kept["memory_analysis"], new["memory_analysis"]
    assert mn["output_bytes"] == mk["output_bytes"] + cache
    assert mn["temp_bytes"] == mk["temp_bytes"]
    assert mn["argument_bytes"] == mk["argument_bytes"]


def test_lower_search_on_a_mesh_equals_the_reference(dry, reference_search):
    mesh = dry((4, 2), ("data", "model"))
    rep = dryrun_search.lower_search(mesh, **SEARCH)
    out, err = reference_search.communicate(timeout=300)
    assert reference_search.returncode == 0, err[-3000:]
    want = json.loads(next(ln for ln in out.splitlines()
                           if ln.startswith("RESULT "))[len("RESULT "):])
    for key in ("world", "flops_per_device", "bytes_per_device",
                "n_total_series", "note", "model_flops_global"):
        assert rep[key] == want[key], key
    assert rep["n_total_series"] == 8 * SEARCH["n_per_shard"]
    t, wt = rep["terms_seconds"], want["terms_seconds"]
    # the reference's terms at TPU v5e rates (197 TFLOP/s, 819 GB/s)
    assert t["compute"] == pytest.approx(
        wt["compute"] * 197e12 / roofline.PEAK_FLOPS, rel=1e-12)
    assert t["memory"] == pytest.approx(
        wt["memory"] * 819e9 / roofline.HBM_BW, rel=1e-12)
    # the engine's merge: one all-gather over the 8 shards a query batch,
    # its int32 payload: dists and ids [B, k], two counts [B], three
    # scalars (lb_computed, iterations, the rank's loop microseconds)
    b, k = SEARCH["batch"], SEARCH["k"]
    payload = (2 * b * k + 2 * b + 3) * 4
    assert rep["n_collectives"] == 1
    assert rep["top_collectives"] == [
        {"op": "all-gather", "wire_bytes": 8 * payload * 7 / 8, "group": 8}]
    assert rep["mesh"] == [4, 2] and rep["mesh_axes"] == ["data", "model"]


def test_main_writes_both_mesh_directories(smoke_configs, tmp_path):
    with pytest.raises(SystemExit) as stop:
        dryrun.main(["--arch", "gemma2-2b", "--shape", "decode_32k",
                     "--mesh", "both", "--out", str(tmp_path)])
    assert stop.value.code == 0
    for name, shape in (("single_pod_16x16", [16, 16]),
                        ("multi_pod_2x16x16", [2, 16, 16])):
        rep = json.loads((tmp_path / name
                          / "gemma2-2b__decode_32k.json").read_text())
        assert rep["status"] == "ok" and rep["mesh"] == shape
        assert rep["world"] == 256 * (len(shape) - 1)
    dryrun_search.main(["--mesh", "both", "--out", str(tmp_path),
                        "--n-per-shard", "8192"])
    for name, world in (("single_pod_16x16", 256),
                        ("multi_pod_2x16x16", 512)):
        rep = json.loads((tmp_path / name
                          / "search-engine__scan.json").read_text())
        assert rep["world"] == world and rep["n_collectives"] == 1
        assert rep["n_total_series"] == 8192 * world
    assert not torch.distributed.is_initialized()
