"""queries_per_s: every query answered in the timed window over the
window's seconds, from the first batch's send to the last one's answer
on the host (closed loop)."""


def read(rec):
    return sum(b.queries.shape[0] for b in rec.window) / rec.window_s
