"""loop.syncs_per_iteration: the host's waits on the device from inside
the system's entry in the profiled window (CUDA ``*Synchronize`` calls:
every read of a device value, every copy to pageable host memory), over
the refinement iterations its batches ran. The harness's own wait before
each send and its copies of the answers lie outside the entry and are
not counted."""


def read(rec):
    tr = rec.trace
    if not tr or not tr["iterations"] or not tr["entry_ops"]:
        return None
    return tr["entry_syncs"] / tr["iterations"]
