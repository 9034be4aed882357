"""loop.launches_per_iteration: device operations (kernels, copies and
sets) launched from inside the system's entry in the profiled window,
over the refinement iterations its batches ran (summed over shards).
The harness's own query draws and copies of the answers to the host lie
outside the entry and are not counted."""


def read(rec):
    tr = rec.trace
    if not tr or not tr["iterations"] or not tr["entry_ops"]:
        return None
    return tr["entry_ops"] / tr["iterations"]
