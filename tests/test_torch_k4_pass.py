"""K4's score pass as the cooperative step calls it, on the CPU: the
row-index form of ``coop_score_select`` against the same call on the
gathered rows, the lane tile it picks, the ``kernels.k4_tiles``
counters, and ``refine_step``'s cooperative raw branch through a
resident source and through an out-of-core cache whose slots are not
the rows' positions. The kernel itself is held against these in
tests/test_torch_gpu.py."""

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.core import refine
from repro_torch.core import search as S
from repro_torch.core.index import FrozenIndex
from repro_torch.core.indexes import dstree
from repro_torch.data import randomwalk
from repro_torch.kernels import ops, topk
from repro_torch.store import DeviceLeafCache
from repro_torch.store.ooc import CachedStoreSource

N_DIMS = 16
R = 1000  # slots: not a multiple of the 128-slot row tile


def _pool(seed, b, dtype, mask):
    """Queries [b, n], a source of 700 rows, an index [R] into it with
    repeats, the slots' norms and distinct ids; masked slots carry -1:
    every 7th ("sparse"), whole 128-slot runs ("runs"), or all."""
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(b, N_DIMS, generator=g)
    src = torch.randn(700, N_DIMS, generator=g).to(dtype)
    index = torch.randint(0, 700, (R,), generator=g)
    norms = ops.row_sq_norms(src)[index]
    ids = torch.randperm(R, generator=g).to(torch.int32)
    if mask == "sparse":
        ids[::7] = -1
    elif mask == "runs":
        for t in (0, 3, 7):  # the last run is the ragged one
            ids[t * topk.ROW_TILE:(t + 1) * topk.ROW_TILE] = -1
    else:
        ids[:] = -1
    return q, src, index, norms, ids


@pytest.mark.parametrize("mask", ["sparse", "runs", "all"])
@pytest.mark.parametrize("b", [1, 100, 256, 257])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_index_form_equals_the_gathered_rows(dtype, b, mask):
    """Slot r read through the index is the gathered row r: the scores
    and the selection equal the dense call's bit for bit; masked slots
    come back as (inf, -1), a fully masked pool all of them."""
    q, src, index, norms, ids = _pool(b, b, dtype, mask)
    kk = 200
    got = ops.coop_score_select(q, src, norms, ids, kk, index=index)
    want = ops.coop_score_select(q, src[index], norms, ids, kk)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(topk.score_pass(q, src, norms, ids, index),
                       topk.score_pass(q, src[index], norms, ids))
    live = int((ids >= 0).sum())
    assert bool((got[1][:, :min(kk, live)] >= 0).all())
    assert bool((got[1][:, live:] == -1).all())
    assert bool(torch.isinf(got[0][:, live:]).all())


def test_index_form_rejects_kk_above_its_slots():
    q, src, index, norms, ids = _pool(0, 4, torch.float32, "sparse")
    with pytest.raises(ValueError, match="exceeds the pool"):
        ops.coop_score_select(q, src, norms[:5], ids[:5], 6,
                              index=index[:5])


@pytest.mark.parametrize("b,lanes", [(1, 104), (100, 104), (104, 104),
                                     (105, 128), (128, 128), (200, 104),
                                     (256, 128), (257, 104), (512, 128)])
def test_lane_tile_pads_the_fewest_lanes(b, lanes):
    """The reference's B = 100 keeps its 104-lane tile; B = 256 pads no
    lane (at most 3% is the bound)."""
    assert topk.lane_tile(b) == lanes
    padded = -(-b // lanes) * lanes
    assert all(padded <= -(-b // t) * t for t in topk.LANE_TILES)
    if b == 256:
        assert padded - b <= 0.03 * padded


def _tiles():
    reg = obs.REGISTRY
    return (reg.counter("kernels.k4_tiles", state="scored").value,
            reg.counter("kernels.k4_tiles", state="skipped").value)


@pytest.mark.parametrize("b", [100, 256, 257])
def test_count_tiles_counts_row_tiles_times_lane_tiles(b):
    """Three launches of R slots: a row tile with no kept slot is skipped
    for every lane tile, the ragged last one included."""
    kept = torch.ones(3, R, dtype=torch.bool)
    kept[0, :256] = False                  # row tiles 0 and 1
    kept[1, 7 * topk.ROW_TILE:] = False    # the ragged last tile
    kept[2, 130:250] = False               # part of tile 1: scored
    kept[2, 400] = False
    lt = -(-b // topk.lane_tile(b))
    s0, k0 = _tiles()
    topk.count_tiles(kept, b)
    s1, k1 = _tiles()
    assert (s1 - s0, k1 - k0) == ((3 * 8 - 3) * lt, 3 * lt)


@pytest.fixture(scope="module")
def walk():
    data = randomwalk.generate(seed=4, n_series=1024, series_len=N_DIMS)
    return data, dstree.build(data, leaf_cap=64, device="cpu")


def _window(ix, b, v, seed):
    """A [b, v] leaf window in which lanes share leaves, all usable but
    the last slot of the last lane."""
    g = torch.Generator().manual_seed(seed)
    leaf = torch.randint(0, ix.num_leaves, (b, v), generator=g)
    leaf[1:, 0] = leaf[0, 0]
    ok = torch.ones(b, v, dtype=torch.bool)
    ok[-1, -1] = False
    return leaf, ok


@pytest.mark.parametrize("codec", ["f32", "bf16"])
def test_share_step_through_resident_and_cached_sources(walk, tmp_path,
                                                        codec):
    """refine_step's cooperative raw branch reads the pooled rows through
    gather_idx: through a cache whose slot positions differ from the
    rows' positions it answers as the dense formulation does on the
    gathered pool (the step before the index form), and, for f32, as the
    resident source does."""
    data, ix = walk
    ix.save(str(tmp_path / codec), codec=codec)
    store = FrozenIndex.load(str(tmp_path / codec), resident="summaries",
                             device="cpu")
    b, v, k = 6, 3, 5
    q = torch.as_tensor(data[:b] + 0.05)
    leaf, ok = _window(ix, b, v, seed=1)
    cached = CachedStoreSource(store, DeviceLeafCache(store, b * v + 2),
                               prefetch=False)
    sources = {"cached": cached}
    if codec == "f32":
        sources["resident"] = refine.ResidentSource(ix)
    top_d = torch.full((b, k), float("inf"))
    top_i = torch.full((b, k), -1, dtype=torch.int32)
    got = {}
    for name, src in sources.items():
        ctx, g = src.query_ctx(q), src.gather(leaf, ok)
        valid = refine.coop_mask(leaf, ok, g.valid)
        got[name] = refine.refine_step(ctx, g.pool, g.gather_idx,
                                       g.row_idx, valid, top_d, top_i,
                                       share=True, pq=False)
        cand = torch.where(valid, ctx.ids[g.row_idx], -1).reshape(-1)
        old = ops.dedup_merge_topk(*ops.coop_score_select(
            ctx.qf, g.pool[g.gather_idx.reshape(-1)],
            ctx.norms[g.row_idx.reshape(-1)], cand,
            min(2 * k, cand.shape[0])), top_d, top_i)
        assert torch.equal(got[name][0], old[0])
        assert torch.equal(got[name][1], old[1])
        if name == "cached":
            assert not torch.equal(g.gather_idx, g.row_idx)
        assert bool((got[name][1] >= 0).all())
    if codec == "f32":
        assert torch.equal(got["cached"][0], got["resident"][0])
        assert torch.equal(got["cached"][1], got["resident"][1])


@pytest.mark.parametrize("share", [True, False])
def test_k4_tiles_count_with_a_sink_on(walk, monkeypatch, share):
    """With a sink on, the cooperative loop adds each iteration's tiles:
    scored + skipped = iterations x row tiles x lane tiles, and the
    skipped ones are the row tiles with no kept slot (lanes that pool one
    leaf leave whole tiles masked). With the sink off, or solo, the
    counters stay as they were."""
    data, ix = walk
    q = torch.as_tensor(np.repeat(data[:1], 8, 0) + 0.01)  # one leaf order
    seen = []
    real = S.refine.coop_mask

    def spy(leaf, ok, valid):
        m = real(leaf, ok, valid)
        seen.append(m.reshape(-1))
        return m

    monkeypatch.setattr(S.refine, "coop_mask", spy)
    before = _tiles()
    S.refine_loop(S.refine.ResidentSource(ix), q, 5, nprobe=6,
                  visit_batch=2, share_gathers=share)
    assert _tiles() == before  # no sink on
    seen.clear()
    obs.enable()
    try:
        S.refine_loop(S.refine.ResidentSource(ix), q, 5, nprobe=6,
                      visit_batch=2, share_gathers=share)
    finally:
        obs.disable()
        obs.clear()
    scored, skipped = (a - b for a, b in zip(_tiles(), before))
    if not share:
        assert (scored, skipped) == (0, 0) and not seen
        return
    r = seen[0].shape[0]
    row_tiles = -(-r // topk.ROW_TILE)
    pad = row_tiles * topk.ROW_TILE - r
    kept = sum(int(torch.cat([m, m.new_zeros(pad)]).view(row_tiles, -1)
                   .any(1).sum()) for m in seen)
    assert scored == kept and skipped == len(seen) * row_tiles - kept > 0


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("rows", ["indexed", "shifted"])
def test_chip_smoke_holds_the_step_s_index_form(walk, rows):
    """chip_smoke.PathInputs records the cooperative step's K4 call with
    its ``index`` keyword, and holds it against the plain version over
    ``rows[index]``: the step's own call passes, one that reads other
    rows than its index names fails the check."""
    C = _chip_smoke()
    data, ix = walk
    q = torch.as_tensor(data[:8] + 0.05)
    real = ops.coop_score_select

    def shifted(qf, src, norms, ids, kk, index=None):
        return real(qf, src, norms, ids, kk, index=torch.roll(index, 1))

    shifted.launches = 0
    fn = real if rows == "indexed" else shifted
    path = C.PathInputs(torch, ops, topk.ref, {"coop_score_select": fn})
    with path:
        S.search(ix, q, 5, share_gathers=True, device="cpu")
    assert ops.coop_score_select is fn
    keys = list(path.seen)
    assert keys and all(k[0] == "coop_score_select" and k[-1][0] == "index"
                        for k in keys)
    if rows == "indexed":
        assert path.check("share") == keys
    else:
        with pytest.raises(AssertionError, match="share"):
            path.check("share")
    ops.coop_score_select = real
