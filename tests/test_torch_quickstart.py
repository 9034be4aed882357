"""The paper's loop end to end (examples/quickstart.py, reduced to
N = 1024 series of length 64): both packages print the same table. MRE
is compared within 1e-4 rather than as printed: on exact rows it is
rounding noise around 0 whose sign the two packages' arithmetic sets
differently (-0.0000 against 0.0000)."""

import jax.numpy as jnp

from repro.core import search as jsearch
from repro.core.guarantees import delta_epsilon, epsilon, exact, ng
from repro.core.indexes import dstree as jdstree
from repro.core.indexes import isax as jisax
from repro.core.indexes import vafile as jvafile
from repro.core.metrics import workload_metrics as jmetrics
from repro.data import queries as jqueries
from repro.data import randomwalk as jrandomwalk
from repro_torch.core import guarantees as G
from repro_torch.core import search
from repro_torch.core.indexes import dstree, isax, vafile
from repro_torch.core.metrics import workload_metrics
from repro_torch.data import queries, randomwalk

N, LEN, K, LEAF_CAP = 1024, 64, 10, 64


def _row(iname, gname, m, leaves, rows):
    """(the printed row without its MRE column, the MRE)."""
    return (f"{iname:9s} {gname:13s} {m['map']:6.3f} "
            f"{m['avg_recall']:7.3f} {leaves:7.0f} "
            f"{100 * rows / N:6.2f}%", m["mre"])


def reference_table():
    data = jrandomwalk.generate(seed=11, n_series=N, series_len=LEN)
    q = jnp.asarray(jqueries.noisy_queries(data, 16))
    truth = jsearch.brute_force(q, jnp.asarray(data), K)
    indexes = {"isax2+": (jisax.build(data, leaf_cap=LEAF_CAP), 1),
               "dstree": (jdstree.build(data, leaf_cap=LEAF_CAP), 1),
               "va+file": (jvafile.build(data), 64)}
    gs = {"exact": exact(), "eps=1": epsilon(1.0),
          "d=.99,eps=1": delta_epsilon(0.99, 1.0), "ng(nprobe=4)": ng(4)}
    out = []
    for iname, (idx, vb) in indexes.items():
        for gname, g in gs.items():
            res = jsearch.search_with_guarantee(idx, q, K, g,
                                                visit_batch=vb)
            m = jmetrics(res.ids, res.dists, truth.ids, truth.dists)
            out.append(_row(iname, gname, m,
                            float(res.leaves_visited.mean()),
                            float(res.rows_scanned.mean())))
    return out


def port_table():
    data = randomwalk.generate(seed=11, n_series=N, series_len=LEN)
    q = queries.noisy_queries(data, 16)
    truth = search.brute_force(q, data, K, device="cpu")
    indexes = {
        "isax2+": (isax.build(data, leaf_cap=LEAF_CAP, device="cpu"), 1),
        "dstree": (dstree.build(data, leaf_cap=LEAF_CAP, device="cpu"), 1),
        "va+file": (vafile.build(data, device="cpu"), 64)}
    gs = {"exact": G.exact(), "eps=1": G.epsilon(1.0),
          "d=.99,eps=1": G.delta_epsilon(0.99, 1.0), "ng(nprobe=4)": G.ng(4)}
    out = []
    for iname, (idx, vb) in indexes.items():
        for gname, g in gs.items():
            res = search.search(idx, q, K, g, visit_batch=vb, device="cpu")
            m = workload_metrics(res.ids, res.dists, truth.ids, truth.dists)
            out.append(_row(iname, gname, m,
                            float(res.leaves_visited.float().mean()),
                            float(res.rows_scanned.float().mean())))
    return out


def test_quickstart_tables_equal():
    want, got = reference_table(), port_table()
    assert [row for row, _ in got] == [row for row, _ in want]
    for (row, mre), (_, want_mre) in zip(got, want):
        assert abs(mre - want_mre) <= 1e-4, row
    assert all(" 1.000 " in row for row, _ in got if " exact " in row)
