"""mesh.wait_share: the share of rank 0's query time spent in the
merge across cards, the program's counters ``engine.mesh_s{part=gather}``
(host seconds inside the answers' all_gather, up to the gathered tails
on the host: the wait for the slowest shard, then the exchange) over
that plus ``engine.mesh_s{part=loop}`` (host seconds of the rank's own
search, from the query's entry to its own answer). Both are totals of
the process, read from ``repro_torch.obs.REGISTRY``: every batch rank 0
sent (warm-up, window and profiled stretch). Absent from a program that
does not count them, and where no gather ran."""


def read(rec):
    from repro_torch.obs import REGISTRY

    snap = REGISTRY.snapshot("engine.mesh_s")
    loop = snap.get("engine.mesh_s{part=loop}")
    gather = snap.get("engine.mesh_s{part=gather}")
    if not loop or not gather:
        return None
    return gather / (loop + gather)
