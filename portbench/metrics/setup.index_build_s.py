"""setup.index_build_s: the host seconds of the engine's index build in
the run's set-up (the DSTree's splits on the host, its boxes and rows
moved to the card), the program's gauge ``engine.build_s{phase=index}``
in ``repro_torch.obs.REGISTRY``, written once a build. Read only where
the profiled stretch kept a device busy: a CPU run is a test of the
harness at a tiny size, not a cell's set-up. Absent from a program that
does not time its build."""


def read(rec):
    tr = rec.trace
    if not tr or not tr["busy_s"]:
        return None
    from repro_torch.obs import REGISTRY

    v = REGISTRY.snapshot("engine.build_s").get("engine.build_s{phase=index}")
    return v or None
