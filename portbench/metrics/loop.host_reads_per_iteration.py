"""loop.host_reads_per_iteration: the program's own count of the places
in the query path where the host waited on the device
(``search.host_reads``, every site: the loop's refill test and
``settle``'s flag once an iteration, its two scalar uploads once a
batch), over the refinement iterations it counted
(``search.iterations``). Both are totals of the process, read from
``repro_torch.obs.REGISTRY``: every batch the run sent (warm-up, window
and profiled stretch, which are alike), since a reader sees the program
only after the run. Read only where the profiled stretch kept a device
busy: on a CPU the reads wait for nothing. Absent from a program that
does not count them."""


def read(rec):
    tr = rec.trace
    if not tr or not tr["busy_s"]:
        return None
    from repro_torch.obs import REGISTRY

    snap = REGISTRY.snapshot("search.")
    reads = sum(v for k, v in snap.items()
                if k.startswith("search.host_reads{"))
    iterations = snap.get("search.iterations")
    if not reads or not iterations:
        return None
    return reads / iterations
