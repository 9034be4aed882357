"""search.batch_roofline: the least time the card could answer the timed
window's batches in, over the time they took (%), with the profiler
off.

The work is what the answers need, whatever computes it, and the same
in every mode: the filter reads each leaf box once a batch and spends 4
operations a box dimension a lane; each lane's scanned rows (the
results' ``rows_scanned``) are read once and scored once (2 operations a
value). The least time is the larger of the operations over the f32
peak (no tensor cores) and the bytes over the HBM bandwidth
(``frozen/peaks.py``). Extra scoring, as the cooperative mode's, is not
credited."""

from portbench.frozen import peaks


def least_seconds(facts: dict, lanes: int, rows: int) -> float:
    L, D = facts["leaves"], facts["box_dims"]
    n, k, w = facts["series_len"], facts["k"], facts["bytes_per_value"]
    ops = lanes * L * D * 4.0 + 2.0 * rows * n
    moved = (L * D * 2 * 4.0 + rows * n * w + lanes * n * 4.0
             + lanes * k * 8.0)
    return max(ops / peaks.F32_FLOPS, moved / peaks.HBM_BYTES_PER_S)


def read(rec):
    if rec.trace is None:
        return None
    least = sum(least_seconds(rec.facts, b.queries.shape[0], r)
                for b, r in zip(rec.window, rec.window_rows))
    took = sum(b.done - b.sent for b in rec.window)
    return 100.0 * least / took
