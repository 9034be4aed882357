"""repro_torch's sharding rules against the JAX package's, with no world:
``params.resolve_pspec`` on every leaf of ``model_specs`` for all ten
configs at full size and on every model input of every applicable cell,
on the single-pod (16, 16), two-pod (2, 16, 16) and test (4, 2) meshes
(the reference's resolver called with a mesh-shape dict, so that jax
needs no devices; specs only, nothing allocated); ``mesh_rules`` with and
without overrides; the entries' DTensor placements; ``constrain`` and
``unshard_fsdp`` as the identity without a mesh; and the
``sequence_parallel`` flag as a numerical identity without one (the
reference's ``tests/test_perf_variants.py``). The rules are compared
entry for entry (``==``): there is no tolerance.

The few tests that need a DeviceMesh run in a world of one rank on the
CPU (gloo on a HashStore) that they tear down.
"""

import dataclasses
import types

import jax
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.configs import shape_applicable as jshape_applicable
from repro.launch import sharding as JSH
from repro.models import model as JM
from repro.models import params as JP
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, \
    get_smoke_config
from repro_torch.launch import mesh as MESH
from repro_torch.launch import sharding as SH
from repro_torch.models import model as M
from repro_torch.models import params as P
from repro_torch.models import sharding_utils as SU
from repro_torch.train import compress as C
from repro_torch.train import optimizer as O

MESHES = {
    "single_pod": {"data": 16, "model": 16},
    "two_pods": {"pod": 2, "data": 16, "model": 16},
    "test": {"data": 4, "model": 2},
}


def _jrules(sizes, overrides=None):
    return JSH.mesh_rules(types.SimpleNamespace(axis_names=tuple(sizes)),
                          overrides)


def _jleaves(tree):
    """{dotted path: ParamSpec} of a reference spec tree."""
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=JP.is_spec)[0]
    return {".".join(str(k.key) for k in path): s for path, s in flat}


def _entries(pspec):
    return tuple(tuple(e) if isinstance(e, (list, tuple)) else e
                 for e in pspec)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_mesh_rules_match_reference(mesh):
    sizes = MESHES[mesh]
    assert SH.mesh_rules(sizes) == _jrules(sizes)
    over = {"heads": None, "mlp": ("data", "model"), "batch": "pod"}
    assert SH.mesh_rules(sizes, over) == _jrules(sizes, over)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_resolve_pspec_matches_reference_on_every_leaf(arch, mesh):
    """Full-size configs, specs only: every parameter's entries."""
    sizes = MESHES[mesh]
    rules = SH.mesh_rules(sizes)
    want = _jleaves(JM.model_specs(jget_config(arch)))
    got = dict(P.spec_leaves(M.model_specs(get_config(arch))))
    assert sorted(got) == sorted(want)
    pspecs = SH.by_path(SH.param_pspecs(get_config(arch), sizes))
    sharded = 0
    for path, spec in got.items():
        js = want[path]
        assert tuple(spec.shape) == tuple(js.shape), path
        assert tuple(spec.logical) == tuple(js.logical), path
        ref = _entries(JP.resolve_pspec(js.logical, js.shape, rules, sizes))
        assert P.resolve_pspec(spec.logical, spec.shape, rules,
                               sizes) == ref, path
        assert pspecs[path] == ref, path
        sharded += any(e is not None for e in ref)
    assert sharded > 0


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_input_pspecs_match_reference(mesh):
    """Every model input (tokens, labels, frames, the decode cache) of
    every applicable (config, shape) cell."""
    sizes = MESHES[mesh]
    rules = SH.mesh_rules(sizes)
    n = 0
    for arch in ARCH_IDS:
        for name, shape in SHAPES.items():
            jshape = JSHAPES[name]
            if not jshape_applicable(jget_config(arch), jshape):
                continue
            want = _jleaves(JM.input_specs(jget_config(arch), jshape))
            got = dict(P.spec_leaves(M.input_specs(get_config(arch),
                                                   shape)))
            assert sorted(got) == sorted(want), (arch, name)
            for path, spec in got.items():
                js = want[path]
                ref = _entries(JP.resolve_pspec(js.logical, js.shape, rules,
                                                sizes))
                assert P.resolve_pspec(spec.logical, spec.shape, rules,
                                       sizes) == ref, (arch, name, path)
                n += 1
    assert n > 100


def test_resolver_keeps_the_divisible_prefix_and_never_reuses_an_axis():
    sizes = {"pod": 2, "data": 16, "model": 16}
    rules = {"a": ("data", "model"), "b": "model", "c": ("pod", "data")}
    # the whole rule divides; 'model' is then used up for the next dim
    assert P.resolve_pspec(("a", "b"), (512, 64), rules, sizes) == (
        ("data", "model"),)
    # only the data factor divides 48: the prefix ('data',) is kept
    assert P.resolve_pspec(("a", "b"), (48, 64), rules, sizes) == (
        "data", "model")
    # trailing unsharded dims are stripped, leading ones kept
    assert P.resolve_pspec((None, "c", None), (3, 64, 5), rules,
                           sizes) == (None, ("pod", "data"))
    assert P.resolve_pspec(("b",), (7,), rules, sizes) == ()


def test_placements_map_entries_to_shard_and_replicate():
    mesh = {"pod": 2, "data": 4, "model": 2}
    assert P.placements((), mesh) == (Replicate(),) * 3
    assert P.placements((None, "model"), mesh) == (
        Replicate(), Replicate(), Shard(1))
    assert P.placements((("pod", "data"), None, "model"), mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert P.placements(("data", "model"), mesh) == (
        Replicate(), Shard(0), Shard(1))
    # a mesh dim of one rank holds the whole tensor: replicated
    assert P.placements((("pod", "data"), "model"),
                        {"pod": 1, "data": 4, "model": 1}) == (
        Replicate(), Shard(0), Replicate())


def test_constrain_and_unshard_fsdp_are_the_identity_without_a_mesh():
    x = torch.randn(4, 6, 8)
    assert SU.ambient_mesh() is None and SU.ambient_axis_sizes() == {}
    assert SU.constrain(x, "batch", "seq_model", None) is x
    assert SU.unshard_fsdp(x, "fsdp", "heads", "head_dim") is x
    with SU.use_mesh(None):
        assert SU.constrain(x, "batch", None, None) is x
    with SU.use_act_map({"batch": ("data", "model")}):
        assert SU._act_axes("batch") == ("data", "model")
    assert SU._act_axes("batch") == ("pod", "data")


def test_sequence_parallel_flag_is_numerically_identity():
    """The port of the reference's tests/test_perf_variants.py: without a
    mesh the constraints are the identity, so the flag leaves the loss of
    the minitron-8b smoke config unchanged, bit for bit."""
    cfg = get_smoke_config("minitron-8b")
    cfg_sp = dataclasses.replace(cfg, sequence_parallel=True)
    model = M.Model.init(cfg, 0, "cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 16),
                         generator=torch.Generator().manual_seed(0))
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    l1, _ = M.loss_fn(model, batch, cfg)
    l2, _ = M.loss_fn(model, batch, cfg_sp)
    torch.testing.assert_close(l2, l1, atol=0, rtol=0)


def test_abstract_opt_state_and_logical_sds():
    cfg = get_config("llama3-405b")
    ocfg = O.OptConfig(state_dtype=torch.bfloat16)
    st = SH.abstract_opt_state(cfg, ocfg)
    specs = dict(P.spec_leaves(M.model_specs(cfg)))
    assert list(st.mu) == sorted(specs, key=lambda p: p.split("."))
    assert all(t.device.type == "meta" and t.dtype == torch.bfloat16
               and tuple(t.shape) == specs[k].shape
               for k, t in st.mu.items())
    assert st.step.dtype == torch.int32 and st.step.shape == ()
    assert set(SH.abstract_params(cfg)) == set(M.model_specs(cfg))
    mesh = MESHES["single_pod"]
    sds = P.logical_sds((1024, 4096), ("batch", "embed"), torch.bfloat16,
                        SH.mesh_rules(MESHES["single_pod"]),
                        MESHES["single_pod"])
    assert sds.spec == ("data",) and sds.shape == (1024, 4096)
    assert P.placements(sds.spec, mesh) == (Shard(0), Replicate())


# ------------------------------------------------------- a world of one
@pytest.fixture
def world1():
    MESH.init_world("cpu")
    yield MESH.make_mesh((1, 1), ("data", "model"), "cpu")
    MESH.destroy_world()


def test_opt_shardings_follow_the_parameters(world1):
    cfg = get_smoke_config("deepseek-moe-16b")
    osh = SH.opt_shardings(cfg, O.OptConfig(), world1)
    psh = SH.by_path(SH.param_shardings(cfg, world1))
    assert osh.step == (Replicate(), Replicate())
    assert osh.mu == psh and osh.nu == psh
    # at world 1 every leaf is whole on its rank, whatever its spec
    assert set(psh.values()) == {(Replicate(), Replicate())}
    pspecs = SH.by_path(SH.param_pspecs(cfg, world1))
    assert pspecs["blocks.sub0.moe.wi_gate"] == (None, "model", "data")
    # the expert stacks: experts over 'model', their fsdp dim over 'data'
    assert SH.by_path(SH.param_shardings(cfg, {"data": 2, "model": 2}))[
        "blocks.sub0.moe.wi_gate"] == (Shard(2), Shard(1))
    logical = P.logical_sds((8, 16), ("batch", "seq"), torch.int32,
                            SH.mesh_rules(world1), world1)
    assert logical.spec == ("data",)
    assert logical.placements == (Replicate(), Replicate())


def test_compressed_psum_at_one_rank_is_the_local_quantization(world1):
    r = np.random.default_rng(0)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.as_tensor(r.normal(size=(64, 33)).astype(np.float32)
                            * 3).to(dtype)
        q, s = C._quantize(x.float())
        want = C._dequantize(q, s).to(dtype)
        got = C.compressed_psum(x, world1["data"])
        assert got.dtype == dtype
        assert torch.equal(got, want)
        assert torch.equal(C.compressed_psum(x), want)


def test_sharded_model_at_one_rank_equals_the_plain_model(world1):
    """A (1, 1) mesh: the DTensor step's loss and parameters equal the
    plain step's bit for bit (the collectives of a world of one move
    nothing)."""
    from repro_torch.train.train_step import build_train_step

    cfg = dataclasses.replace(get_smoke_config("minitron-8b"),
                              param_dtype=torch.float32,
                              compute_dtype=torch.float32)
    ocfg = O.OptConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    plain = M.Model.init(cfg, 0, "cpu")
    dist = SH.distribute_params(M.Model.init(cfg, 0, "cpu"), world1,
                                SH.param_shardings(cfg, world1))
    sp, sd = O.init(ocfg, plain), O.init(ocfg, dist)
    step = build_train_step(cfg, ocfg)
    toks = torch.randint(0, cfg.vocab_size, (2, 16),
                         generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    from torch.distributed.tensor import DTensor

    dbatch = {k: DTensor.from_local(v, world1, (Replicate(), Replicate()))
              for k, v in batch.items()}
    _, sp, mp = step(plain, sp, batch)
    with SU.use_mesh(world1):
        _, sd, md = step(dist, sd, dbatch)
    assert float(md["loss"]) == float(mp["loss"])
    for k, v in plain.reference_leaves().items():
        assert torch.equal(dist.reference_leaves()[k].full_tensor(), v), k
