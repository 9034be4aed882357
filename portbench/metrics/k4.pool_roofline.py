"""k4.pool_roofline: the least time the card could do the useful work of
the cooperative score pass in, over the device time the pass took in the
profiled stretch (%).

The useful work is what the program counted while the profiler recorded
(``repro_torch.obs.REGISTRY``; the program counts it only while a span
sink is on, which in a run is the profiled stretch alone):
``search.pooled_rows``, each iteration's distinct valid pooled rows, each
read once (``series_len`` values of ``bytes_per_value``), and
``search.pooled_pairs``, those rows times the lanes still active, each
pair scored once (2 operations a value). The least time is the larger
of the operations over the f32 peak (no tensor cores) and the bytes over
the HBM bandwidth (``frozen/peaks.py``); the time is the device time of
``l2_tile_kernel<float, true>`` (``repro_torch/kernels/csrc/
gemm_tile.cuh``'s row-norm variant, which only K4 launches). The pass
scores every slot of the pool against every lane; this credits the
distinct valid rows of the lanes still searching. Absent where the
program does not count the pool or K4 did not run."""

from portbench.frozen import peaks

KERNEL = "l2_tile_kernel<float, true>"


def read(rec):
    tr = rec.trace
    if not tr:
        return None
    from repro_torch.obs import REGISTRY

    snap = REGISTRY.snapshot("search.pooled_")
    rows = snap.get("search.pooled_rows")
    pairs = snap.get("search.pooled_pairs")
    s = sum(v for name, v in tr["device_s_by_name"].items()
            if KERNEL in name)
    if not rows or not pairs or not s:
        return None
    n, w = rec.facts["series_len"], rec.facts["bytes_per_value"]
    least = max(2.0 * n * pairs / peaks.F32_FLOPS,
                n * w * rows / peaks.HBM_BYTES_PER_S)
    return 100.0 * least / s
