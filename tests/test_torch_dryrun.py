"""repro_torch's dry run (launch/dryrun.py, launch/dryrun_search.py) and
the two model helpers it stands on, against the JAX package.

* ``model.input_specs`` equals the reference's spec for spec (shape,
  logical axes, init, scale, the dtype by name) on every config and
  shape, and ``params.abstract`` gives ``meta`` tensors of the shapes
  and dtypes of the reference's ``params.abstract``.
* ``lower_cell`` runs the real entry points on ``meta`` with the smoke
  configs patched in (as tests/test_distributed.py patches the
  reference's), its analytic terms and counts equal to the reference's,
  and one full-width cell, which could not be allocated.
* ``GRAD_ACCUM``, ``OPT_DTYPE`` and ``lower_search``'s analytic half
  equal the reference's, read in a subprocess: importing
  ``repro.launch.dryrun`` or ``dryrun_search`` sets XLA_FLAGS to 512 host
  devices for the process that imports it.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.configs import get_smoke_config as j_get_smoke_config
from repro.configs import shape_applicable as j_shape_applicable
from repro.launch import analytic as j_analytic
from repro.models import model as j_model
from repro.models import params as j_params
from repro_torch import configs
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.launch import dryrun, dryrun_search, roofline
from repro_torch.models import model as model_mod
from repro_torch.models import params as params_mod

ROOT = Path(__file__).resolve().parent.parent
CELLS = [(a, s) for a in ARCH_IDS for s in SHAPES]
SMOKE_ARCHS = ["gemma2-2b", "jamba-v0.1-52b", "mamba2-370m",
               "seamless-m4t-medium"]
SMOKE_CELLS = [(a, s) for a in SMOKE_ARCHS
               for s in ("train_4k", "prefill_32k", "decode_32k")]


def _dtype_name(dt) -> str:
    return (str(dt).removeprefix("torch.") if isinstance(dt, torch.dtype)
            else np.dtype(dt).name)


def _j_spec_leaves(tree):
    return jax.tree_util.tree_leaves(tree, is_leaf=j_params.is_spec)


@pytest.mark.parametrize("arch,shape", CELLS,
                         ids=[f"{a}-{s}" for a, s in CELLS])
def test_input_specs_equal_the_reference(arch, shape):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    got = [s for _, s in params_mod.spec_leaves(
        model_mod.input_specs(cfg, SHAPES[shape]))]
    want = _j_spec_leaves(j_model.input_specs(jcfg, J_SHAPES[shape]))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.shape, g.logical, g.init, g.scale, g.fan_in_axes) \
            == (w.shape, w.logical, w.init, w.scale, w.fan_in_axes)
        assert _dtype_name(g.dtype) == _dtype_name(w.dtype)
    got_abs = [t for t in _meta_leaves(params_mod.abstract(
        model_mod.input_specs(cfg, SHAPES[shape])))]
    want_abs = jax.tree_util.tree_leaves(
        j_params.abstract(j_model.input_specs(jcfg, J_SHAPES[shape])))
    assert [(tuple(t.shape), _dtype_name(t.dtype)) for t in got_abs] \
        == [(tuple(s.shape), _dtype_name(s.dtype)) for s in want_abs]
    assert all(t.device.type == "meta" for t in got_abs)


def _meta_leaves(tree):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _meta_leaves(v)
        else:
            yield v


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_model_equals_the_reference(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    got = list(_meta_leaves(params_mod.abstract(model_mod.model_specs(cfg))))
    want = jax.tree_util.tree_leaves(
        j_params.abstract(j_model.model_specs(jcfg)))
    assert [(tuple(t.shape), _dtype_name(t.dtype)) for t in got] \
        == [(tuple(s.shape), _dtype_name(s.dtype)) for s in want]
    model = model_mod.Model(
        cfg, params_mod.abstract(model_mod.model_specs(cfg)))
    assert model.device.type == "meta"
    assert sum(p.numel() for p in model.parameters()) == jcfg.param_count()


def test_live_bytes_counts_what_a_run_holds():
    x = torch.empty(1000, device="meta")
    with dryrun.LiveBytes([x]) as live:
        y = x * 2               # 4000 bytes
        z = y + 1               # 8000 held
        del y
        w = z.view(10, 100)     # a view: nothing new
        z.add_(1)               # in place: nothing new
        assert live.new_bytes([w, x]) == 4000
    assert (live.peak, live.now) == (8000, 4000)
    with pytest.raises(dryrun.PastLimit):
        with dryrun.LiveBytes([x], limit=6000):
            y = x * 2
            z = y + 1


@pytest.fixture
def smoke_configs():
    with mock.patch.object(dryrun, "get_config", configs.get_smoke_config):
        yield


@pytest.mark.parametrize("arch,shape", SMOKE_CELLS,
                         ids=[f"{a}-{s}" for a, s in SMOKE_CELLS])
def test_lower_cell_on_meta_matches_the_reference(smoke_configs, arch,
                                                  shape):
    rep = dryrun.lower_cell(arch, shape)
    assert rep["status"] == "ok"
    jcfg, jsh = j_get_smoke_config(arch), J_SHAPES[shape]
    accum = dryrun.GRAD_ACCUM[arch]
    remat = jsh.kind == "train" and jcfg.remat_policy == "nothing_saveable"
    want_f = j_analytic.flops_model(jcfg, jsh, grad_accum=accum,
                                    remat=remat)["flops_global"]
    want_b = j_analytic.bytes_model(
        jcfg, jsh, param_count=jcfg.param_count(), grad_accum=accum,
        opt_bytes_per_param=8, remat=remat)["bytes_global"]
    assert rep["flops_per_device"] == want_f
    assert rep["bytes_per_device"] == want_b
    assert rep["total_params"] == jcfg.param_count()
    assert rep["active_params"] == jcfg.active_param_count()
    assert rep["terms_seconds"]["compute"] == want_f / roofline.PEAK_FLOPS
    assert rep["raw_counted_flops_per_device"] > 0
    m = rep["memory_analysis"]
    assert m["argument_bytes"] > 0 and m["temp_bytes"] > 0
    assert m["live_bytes"] == (m["argument_bytes"] + m["output_bytes"]
                               + m["temp_bytes"])
    if jsh.kind == "decode":
        fit = dryrun.fits_hbm(arch, shape)
        assert fit == {"fits_hbm": m["fits_hbm"],
                       "live_bytes": m["live_bytes"]}


def test_long_context_skip_carries_the_reference_reason(smoke_configs):
    rep = dryrun.lower_cell("minitron-8b", "long_500k")
    ok, reason = j_shape_applicable(j_get_config("minitron-8b"),
                                    J_SHAPES["long_500k"])
    assert not ok
    assert rep == {"arch": "minitron-8b", "shape": "long_500k",
                   "status": "skipped", "reason": reason}
    assert dryrun.fits_hbm("minitron-8b", "long_500k")["reason"] == reason


def test_full_width_decode_cell_runs_on_meta():
    """gemma2-2b decode_32k at full width and depth: 416 GiB of cache,
    which only a run that allocates nothing can hold."""
    rep = dryrun.lower_cell("gemma2-2b", "decode_32k")
    assert rep["status"] == "ok"
    m = rep["memory_analysis"]
    assert m["argument_bytes"] > 400 * 2 ** 30 and not m["fits_hbm"]
    assert rep["total_params"] == 2_614_341_888
    assert rep["bottleneck"] == "memory"
    assert dryrun.fits_hbm("gemma2-2b", "long_500k")["fits_hbm"]


def test_main_writes_the_report(smoke_configs, tmp_path):
    with pytest.raises(SystemExit) as stop:
        dryrun.main(["--arch", "mamba2-370m", "--shape", "decode_32k",
                     "--out", str(tmp_path)])
    assert stop.value.code == 0
    rep = json.loads((tmp_path / "single_h100"
                      / "mamba2-370m__decode_32k.json").read_text())
    assert rep["status"] == "ok" and rep["shape"] == "decode_32k"


REF_SCRIPT = """
import json
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh
import repro.launch.dryrun as d
import repro.launch.dryrun_search as ds

mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
out = {"grad_accum": d.GRAD_ACCUM,
       "opt_dtype": {k: jnp.dtype(v).name for k, v in d.OPT_DTYPE.items()},
       "search": {}}
for coop in (False, True):
    with mesh:
        rep = ds.lower_search(mesh, **SEARCH, coop=coop)
    out["search"][str(coop)] = {k: rep[k] for k in (
        "flops_per_device", "bytes_per_device", "n_total_series",
        "terms_seconds", "note")}
print("RESULT " + json.dumps(out))
"""
SEARCH = dict(n_per_shard=8192, series_len=64, batch=8, k=10, nprobe=4,
              visit_batch=2)


@pytest.fixture(scope="module")
def reference_tables():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src"))
    script = f"SEARCH = {SEARCH!r}\n" + textwrap.dedent(REF_SCRIPT)
    proc = subprocess.run([sys.executable, "-c", script], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = next(ln for ln in proc.stdout.splitlines()
                if ln.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


def test_grad_accum_and_opt_dtype_equal_the_reference(reference_tables):
    assert dryrun.GRAD_ACCUM == reference_tables["grad_accum"]
    assert {k: _dtype_name(v) for k, v in dryrun.OPT_DTYPE.items()} \
        == reference_tables["opt_dtype"]


@pytest.mark.parametrize("coop", [False, True], ids=["solo", "coop"])
def test_lower_search_analytic_half_equals_the_reference(reference_tables,
                                                         coop):
    want = reference_tables["search"][str(coop)]
    rep = dryrun_search.lower_search(**SEARCH, coop=coop)
    for key in ("flops_per_device", "bytes_per_device", "n_total_series",
                "note"):
        assert rep[key] == want[key], key
    t, wt = rep["terms_seconds"], want["terms_seconds"]
    # the reference's terms at TPU v5e rates (197 TFLOP/s, 819 GB/s)
    assert t["compute"] == pytest.approx(
        wt["compute"] * 197e12 / roofline.PEAK_FLOPS, rel=1e-12)
    assert t["memory"] == pytest.approx(
        wt["memory"] * 819e9 / roofline.HBM_BW, rel=1e-12)
    assert t["collective"] == wt["collective"] == 0.0
    m = rep["memory_analysis"]
    assert m["temp_bytes"] is None and m["fits_hbm"]
    assert "measured_seconds" not in rep


def test_abstract_index_has_the_reference_shapes():
    idx, leaves = dryrun_search.abstract_index(2_000_000, 256, 512)
    assert leaves == 3906
    assert tuple(idx.box_lo.shape) == (3906, 16)
    assert tuple(idx.offsets.shape) == (3907,)
    assert tuple(idx.data.shape) == (2_000_000, 256)
    assert idx.data.device.type == "meta" and idx.n_total == 2_000_000
    rep = dryrun_search.lower_search()
    assert rep["memory_analysis"]["argument_bytes"] > 2_000_000 * 256 * 4
