"""repro_torch's v2 store against the JAX package's: stores either
package wrote open in the other with the same arrays, bfloat16 payloads
round to the same bits, and the device leaf cache evicts and counts as
the reference's does; the prefetcher stages, hands out and stops."""

import json
import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.indexes import dstree as jdstree
from repro.core.summaries import pq as jpq
from repro.store import DeviceLeafCache as JCache
from repro.store import layout as jlayout
from repro_torch.core.index import (ARRAY_FIELDS, META_FIELDS, FrozenIndex,
                                    frozen_index_from_arrays)
from repro_torch.store import DeviceLeafCache, LeafPrefetcher, LeafStore
from repro_torch.store import layout

CODECS = ("f32", "bf16", "pq")


@pytest.fixture(scope="module")
def jindex(walk_data):
    return jdstree.build(walk_data, leaf_cap=32)


@pytest.fixture(scope="module")
def jstores(jindex, tmp_path_factory):
    """Stores the reference wrote, by codec."""
    root = tmp_path_factory.mktemp("ref_stores")
    return {c: jlayout.save_index(jindex, str(root / c), codec=c)
            for c in CODECS}


@pytest.fixture(scope="module")
def tindex(jindex):
    """The port's copy of the reference's index, on the CPU."""
    arrays = {f: np.asarray(getattr(jindex, f)) for f in ARRAY_FIELDS}
    arrays["edges"] = np.asarray(jindex.hist.edges)
    arrays["cdf"] = np.asarray(jindex.hist.cdf)
    return frozen_index_from_arrays(
        arrays, {f: getattr(jindex, f) for f in META_FIELDS}, device="cpu")


def host(a):
    """A reference or port array as numpy (bfloat16 as uint16 bits)."""
    if isinstance(a, torch.Tensor):
        return layout.to_host(a)
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def assert_same_index(want, got, fields=ARRAY_FIELDS):
    for f in fields:
        np.testing.assert_array_equal(host(getattr(got, f)),
                                      host(getattr(want, f)), err_msg=f)
    np.testing.assert_array_equal(host(got.hist.edges),
                                  host(want.hist.edges))
    np.testing.assert_array_equal(host(got.hist.cdf), host(want.hist.cdf))
    for f in META_FIELDS:
        assert getattr(got, f) == getattr(want, f), f


@pytest.mark.parametrize("codec", CODECS)
def test_port_opens_reference_stores(jstores, codec):
    want = jlayout.load_index(jstores[codec])
    got = layout.load_index(jstores[codec], device="cpu")
    assert isinstance(got, FrozenIndex)
    if codec == "bf16":
        assert got.data.dtype == torch.bfloat16
    assert_same_index(want, got)


@pytest.mark.parametrize("codec", CODECS)
def test_summaries_keep_the_payload_on_disk(jstores, codec):
    store = layout.load_index(jstores[codec], resident="summaries",
                              device="cpu")
    ref = jlayout.load_index(jstores[codec], resident="summaries")
    assert isinstance(store, LeafStore)
    assert store.resident.data.shape == (0, store.series_len)
    assert store.codec == codec
    assert store.payload_cols == ref.payload_cols
    assert store.dataset_nbytes == ref.dataset_nbytes
    for leaf in (0, store.num_leaves - 1):
        np.testing.assert_array_equal(store.read_leaf(leaf),
                                      host(ref.read_leaf(leaf)))
        assert store.leaf_nbytes(leaf) == ref.leaf_nbytes(leaf)
    if codec == "pq":
        np.testing.assert_array_equal(store.codebook.centroids.numpy(),
                                      np.asarray(ref.codebook.centroids))


@pytest.mark.parametrize("codec", ["f32", "bf16"])
def test_reference_opens_port_stores(jindex, tindex, jstores, tmp_path,
                                     codec):
    """The port writes the reference's bytes: data.bin, meta.json and
    every sidecar array but the bf16 row norms are equal to the
    reference's own store, and the reference reads the port's back."""
    d = tindex.save(str(tmp_path / codec), codec=codec)
    for name in ("data.bin", "meta.json"):
        with open(os.path.join(d, name), "rb") as a, \
                open(os.path.join(jstores[codec], name), "rb") as b:
            assert a.read() == b.read(), name
    got = jlayout.load_index(d)
    want = jlayout.load_index(jstores[codec])
    fields = [f for f in ARRAY_FIELDS if f != "row_norms"]
    assert_same_index(want, got, fields)
    if codec == "f32":
        np.testing.assert_array_equal(np.asarray(got.row_norms),
                                      np.asarray(want.row_norms))
    else:  # the port sums the norms of the bf16 image in another order
        np.testing.assert_allclose(np.asarray(got.row_norms),
                                   np.asarray(want.row_norms), rtol=1e-6)


def test_reference_opens_port_pq_store(tindex, tmp_path):
    """The reference reads the port's pq store, and its own encoder under
    the stored codebook gives the stored codes."""
    d = tindex.save(str(tmp_path / "pq"), codec="pq")
    store = jlayout.load_index(d, resident="summaries")
    codes = np.asarray(jpq.pq_encode(store.codebook,
                                     jnp.asarray(np.asarray(tindex.data))))
    np.testing.assert_array_equal(np.asarray(store.mmap), codes)
    full = jlayout.load_index(d)
    np.testing.assert_array_equal(np.asarray(full.data),
                                  tindex.data.numpy())
    meta = json.load(open(os.path.join(d, "meta.json")))
    assert meta["pq_m"] == 16 and meta["payload_dtype"] == "uint8"


def test_bf16_rounding_matches_reference_bit_for_bit():
    """Tensor.to(bfloat16) and jnp.asarray(x, bfloat16) both round to
    nearest even, ties, subnormals and specials included."""
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2**32, 200_000, dtype=np.uint64).astype(np.uint32)
    # halfway cases: low 16 bits exactly 0x8000
    bits[:5000] = (bits[:5000] & 0xFFFF0000) | 0x8000
    x = bits.view(np.float32)
    x = np.concatenate([x, np.array([0.0, -0.0, 1e-40, -1e-40, np.inf,
                                     -np.inf, 3.4e38, 1.0, 1.00390625],
                                    np.float32)])
    x = x[~np.isnan(x)]
    want = np.asarray(jnp.asarray(x, jnp.bfloat16)).view(np.uint16)
    got = layout.to_host(torch.as_tensor(x).to(torch.bfloat16))
    np.testing.assert_array_equal(got, want)


def test_other_format_versions_raise(jstores, tmp_path):
    for ver in (1, 3):
        d = tmp_path / f"v{ver}"
        os.makedirs(d)
        for name in os.listdir(jstores["f32"]):
            with open(os.path.join(jstores["f32"], name), "rb") as src:
                (d / name).write_bytes(src.read())
        meta = json.loads((d / "meta.json").read_text())
        meta["format_version"] = ver
        (d / "meta.json").write_text(json.dumps(meta))
        with pytest.raises(ValueError, match="format 2 only"):
            layout.load_index(str(d), device="cpu")


def test_load_raises_without_a_card_by_default(jstores):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        layout.load_index(jstores["f32"])


# ------------------------------------------------------------- the cache
SCRIPT = [[0, 1, 2, 3], [0, 1], [4, 4, 5, 0], [6, 7, 8, 9, 1],
          [2, 2, 2], list(range(10, 16)), [0, 3, 5, 7, 9, 11], [15, 14]]


@pytest.mark.parametrize("codec", CODECS)
def test_clock_eviction_and_counters_match_reference(jstores, codec):
    """A scripted leaf sequence through a 6-leaf cache (prefetcher off):
    the same slots, the same counters after every batch, and the same
    payload in the slots."""
    jstore = jlayout.load_index(jstores[codec], resident="summaries")
    store = layout.load_index(jstores[codec], resident="summaries",
                              device="cpu")
    jc, tc = JCache(jstore, 6), DeviceLeafCache(store, 6)
    for batch in SCRIPT:
        np.testing.assert_array_equal(tc.get_slots(batch),
                                      jc.get_slots(batch))
        js, ts = jc.stats(), tc.stats()
        for f in ("hits", "hits_distinct", "misses", "bytes_read",
                  "bytes_read_sync", "bytes_h2d", "hit_rate",
                  "hit_rate_distinct", "capacity_leaves"):
            assert ts[f] == js[f], (batch, f)
        assert tc.slot_of == jc.slot_of
        assert tc.hand == jc.hand
        np.testing.assert_array_equal(tc.refbit, jc.refbit)
    np.testing.assert_array_equal(host(tc.slots), host(jc.slots))
    assert tc.slots.dtype == store.payload_dtype
    tc.reset_counters()
    st = tc.stats()
    assert st.misses == 0 and st.hits == 0 and st.bytes_h2d == 0


def test_cache_rejects_a_batch_larger_than_itself(jstores):
    store = layout.load_index(jstores["f32"], resident="summaries",
                              device="cpu")
    with pytest.raises(RuntimeError, match="cache thrash"):
        DeviceLeafCache(store, 2).get_slots([0, 1, 2])


def test_prefetcher_stages_takes_and_closes(jstores):
    store = layout.load_index(jstores["f32"], resident="summaries",
                              device="cpu")
    pf = LeafPrefetcher(store, depth=2)
    pf.schedule([0, 1, 2])
    for leaf in (1, 0, 2):
        got = pf.take(leaf)
        assert got is not None
        np.testing.assert_array_equal(got, store.read_leaf(leaf))
    assert pf.take(1) is None                # popped exactly once
    assert pf.take(7) is None                # never scheduled
    assert pf.leaves_read == 3
    assert pf.bytes_read == sum(store.leaf_nbytes(i) for i in range(3))
    pf.reset_counters()
    assert pf.bytes_read == 0 and pf.leaves_read == 0
    pf.close()
    assert not pf._thread.is_alive()
    assert pf.take(3) is None


def test_prefetcher_keeps_only_live_batches(jstores):
    store = layout.load_index(jstores["f32"], resident="summaries",
                              device="cpu")
    with LeafPrefetcher(store, depth=1) as pf:
        pf.schedule([0, 1])
        assert pf.take(0) is not None
        pf.schedule([2])                     # batch [0, 1] is dropped
        assert pf.take(1) is None
        assert pf.take(2) is not None


def test_cache_takes_staged_leaves_from_the_prefetcher(jstores):
    store = layout.load_index(jstores["bf16"], resident="summaries",
                              device="cpu")
    with LeafPrefetcher(store) as pf:
        cache = DeviceLeafCache(store, 4, prefetcher=pf)
        pf.schedule([3, 4])
        assert pf.take(3) is not None        # wait for the reads
        pf.schedule([3, 4])
        cache.get_slots([3, 4])
        st = cache.stats()
        assert st.prefetch_hits >= 1
        assert st.bytes_read == st.bytes_read_sync + pf.bytes_read
        for leaf in (3, 4):
            want = store.read_leaf(leaf)
            got = host(cache.slots[cache.slot_of[leaf]])
            np.testing.assert_array_equal(got, want)


def test_concurrent_get_slots_keep_a_consistent_map(jstores):
    store = layout.load_index(jstores["f32"], resident="summaries",
                              device="cpu")
    cache = DeviceLeafCache(store, 8)
    errors = []

    def worker(seed):
        rng = np.random.default_rng(seed)
        try:
            for _ in range(30):
                batch = rng.integers(0, store.num_leaves, 3).tolist()
                slots = cache.get_slots(batch)
                assert len(set(slots.tolist())) == len(set(batch))
        except Exception as e:  # collected for the assertion below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(s,)) for s in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    for leaf, slot in cache.slot_of.items():
        assert cache.owner[slot] == leaf
        np.testing.assert_array_equal(cache.slots[slot].numpy(),
                                      store.read_leaf(leaf))


def test_read_leaf_out_reuse_zeroes_tail(jstores):
    store = layout.load_index(jstores["f32"], resident="summaries",
                              device="cpu")
    sizes = store.offsets_h[1:] - store.offsets_h[:-1]
    big = int(np.argmax(sizes))
    small = int(np.argmin(np.where(sizes > 0, sizes, sizes.max())))
    buf = store.read_leaf(big)
    buf[:] = 7
    out = store.read_leaf(small, out=buf)
    assert out is buf
    assert not np.any(out[store.leaf_size(small):])
