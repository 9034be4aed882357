"""mesh.spread_ms_per_batch: how long, on average, the slowest card's
own search outlasts the fastest's in a batch, in ms: the program's
counter ``engine.mesh_spread_s`` (for each gather, the largest of the
ranks' loop times less the smallest, the times travelling with the
answers) over ``engine.gathers``. Totals of rank 0's process, read from
``repro_torch.obs.REGISTRY``: every batch it sent. Absent from a program
that does not count them, and where no gather ran."""


def read(rec):
    from repro_torch.obs import REGISTRY

    snap = REGISTRY.snapshot("engine.")
    spread = snap.get("engine.mesh_spread_s")
    gathers = snap.get("engine.gathers")
    if spread is None or not gathers:
        return None
    return spread / gathers * 1e3
