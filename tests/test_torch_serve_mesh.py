"""repro_torch's serving entry points across ranks (``model.prefill``,
``model.decode_step`` and ``alloc_cache`` on DTensors) against the
reference's unsharded ``prefill`` and ``decode_step``.

gemma2-2b's smoke config in f32 (a local and a global attention layer a
block), on a (2, 2) ("data", "model") mesh: one gloo world of 4 rank
subprocesses (a FileStore under the test's tmp directory, one OMP thread
a rank). The reference's weights are drawn here and carried to the
ranks by ``params_from_jax``; the parameters are laid out by
``launch/sharding.param_shardings`` and the tokens by
``input_shardings``, and the cache is allocated sharded inside
``prefill`` (``sharding_utils.zeros``). A prefill of 4 x 16 tokens into a
cache of 18 positions, then two decode steps on fixed tokens at
positions 16 and 17 (the reference's cache grown to 18 by its own
``_grow_cache``).

Tolerance: atol = rtol = 1e-4 (f32; the ranks reduce the sharded
contractions in another order than XLA).
"""

import dataclasses
import inspect
import os
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _worlds
from repro.configs import get_smoke_config as jget_smoke
from repro.models import model as JM
from repro.models.params import initialize as jinitialize
from repro.serve.serve_step import _grow_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 300  # seconds for the world
WORLD = 4
ARCH = "gemma2-2b"
B, S, STEPS = 4, 16, 2
TOL = dict(atol=1e-4, rtol=1e-4)


def tokens(vocab):
    r = np.random.default_rng(7)
    return (r.integers(0, vocab, (B, S)).astype(np.int32),
            r.integers(0, vocab, (STEPS, B, 1)).astype(np.int32))


def load_tree(path):
    """The npz of '/'-joined paths as nested dicts of numpy arrays."""
    out = {}
    with np.load(path) as z:
        for key in z.files:
            node = out
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = z[key]
    return out


PORT_RANK = "\n".join([
    "import dataclasses, os, sys", "import numpy as np",
    f"ARCH, B, S, STEPS = {ARCH!r}, {B}, {S}, {STEPS}",
    inspect.getsource(tokens), inspect.getsource(load_tree)]) + \
    textwrap.dedent("""
    import torch
    torch.set_num_threads(1)
    import torch.distributed as dist
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import mesh as MESH
    from repro_torch.launch import sharding as SH
    from repro_torch.models import model as M
    from repro_torch.models import sharding_utils as SU
    from repro_torch.models.convert import params_from_jax

    rank, out = int(sys.argv[1]), sys.argv[2]
    MESH.init_world("cpu", store=dist.FileStore(os.path.join(out, "rdv"),
                                                4), rank=rank, world_size=4)
    mesh = MESH.make_test_mesh((2, 2), ("data", "model"), device="cpu")
    cfg = dataclasses.replace(get_smoke_config(ARCH),
                              param_dtype=torch.float32,
                              compute_dtype=torch.float32)
    model = params_from_jax(load_tree(os.path.join(out, "weights.npz")),
                            cfg, "cpu")
    SH.distribute_params(model, mesh, SH.param_shardings(cfg, mesh))
    prompt, steps = tokens(cfg.vocab_size)

    def laid(t, kind, seq):
        sh = SH.input_shardings(cfg, ShapeSpec("t", kind, seq, B), mesh)
        return SU._distribute(torch.as_tensor(t), mesh, sh["tokens"])

    res = {}
    with SU.use_mesh(mesh):
        logits, cache = M.prefill(model, {"tokens": laid(prompt, "prefill",
                                                         S)}, cfg,
                                  capacity=S + STEPS)
        res["prefill"] = logits.full_tensor().numpy()
        for key, e in cache["blocks"].items():
            res[f"cache.{key}.k"] = e["k"].full_tensor().numpy()
            res[f"cache.{key}.placements"] = np.asarray(
                str(tuple(e["k"].placements)))
        for i in range(STEPS):
            logits, cache = M.decode_step(model, laid(steps[i], "decode", 1),
                                          cache, S + i, cfg)
            res[f"decode.{i}"] = logits.full_tensor().numpy()
        res["cache.final.k"] = cache["blocks"]["sub1"]["k"].full_tensor(
            ).numpy()
    np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
    MESH.destroy_world()
""")


def _jcfg():
    return dataclasses.replace(jget_smoke(ARCH), param_dtype=jnp.float32,
                               compute_dtype=jnp.float32)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the ranks' results by rank, the reference's results)."""
    out = str(tmp_path_factory.mktemp("serve_mesh"))
    jcfg = _jcfg()
    jp = jinitialize(JM.model_specs(jcfg), jax.random.PRNGKey(3))
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    np.savez(os.path.join(out, "weights.npz"),
             **{"/".join(str(p.key) for p in path): np.asarray(v)
                for path, v in flat})
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    procs, logs = _worlds.start(
        {f"rank{r}": ([PORT_RANK, str(r)], env) for r in range(WORLD)}, out)
    try:
        prompt, steps = tokens(jcfg.vocab_size)
        want = {}
        logits, cache = JM.prefill(jp, {"tokens": jnp.asarray(prompt)}, jcfg)
        want["prefill"] = np.asarray(logits)
        for key, e in cache["blocks"].items():
            want[f"cache.{key}.k"] = np.asarray(e["k"])
        cache = _grow_cache(cache, S + STEPS)
        for i in range(STEPS):
            logits, cache = JM.decode_step(jp, jnp.asarray(steps[i]), cache,
                                           jnp.int32(S + i), jcfg)
            want[f"decode.{i}"] = np.asarray(logits)
        want["cache.final.k"] = np.asarray(cache["blocks"]["sub1"]["k"])
        _worlds.run_all(procs, logs, TIMEOUT)
    finally:
        _worlds.stop(procs)
    got = [dict(np.load(os.path.join(out, f"rank{r}.npz")))
           for r in range(WORLD)]
    return got, want


@pytest.mark.parametrize("rank", range(WORLD))
def test_prefill_matches_the_reference(runs, rank):
    got, want = runs
    np.testing.assert_allclose(got[rank]["prefill"], want["prefill"], **TOL)
    for key in ("sub0", "sub1"):
        k = got[rank][f"cache.{key}.k"]
        # the port's cache holds S + STEPS positions, the prompt's first
        np.testing.assert_allclose(k[:, :, :S], want[f"cache.{key}.k"],
                                   **TOL)
        assert not k[:, :, S:].any()


@pytest.mark.parametrize("step", range(STEPS))
def test_decode_steps_match_the_reference(runs, step):
    got, want = runs
    for r in range(WORLD):
        np.testing.assert_allclose(got[r][f"decode.{step}"],
                                   want[f"decode.{step}"], **TOL)
    np.testing.assert_allclose(got[0]["cache.final.k"],
                               want["cache.final.k"], **TOL)


def test_the_cache_is_sharded_over_the_batch(runs):
    got, _ = runs
    for r in range(WORLD):
        # [G, B, cap, Kv, D]: the batch over 'data', the kv heads over
        # 'model' (2 kv heads on 2 ranks)
        assert str(got[r]["cache.sub0.placements"]) == \
            "(Shard(dim=1), Shard(dim=3))"
