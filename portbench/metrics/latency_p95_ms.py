"""latency_p95_ms: the nearest-rank 95th percentile over every query
answered in the timed window, each timed from its batch's send to its
ids and distances on the host; from the raw samples."""

from portbench.frozen.accuracy import percentile


def read(rec):
    samples = []
    for b in rec.window:
        samples += [(b.done - b.sent) * 1e3] * b.queries.shape[0]
    return percentile(samples, 95)
