"""k4.ms_per_launch: the device time of K4's score pass in the profiled
window (the kernel ``l2_tile_kernel<float, true>`` of
``repro_torch/kernels/csrc/gemm_tile.cuh``, the row-norm variant only
K4 launches), over the launches its wrapper
(``repro_torch.kernels.ops.coop_score_select``) counted there (ms)."""

KERNEL = "l2_tile_kernel<float, true>"


def read(rec):
    tr = rec.trace
    if not tr:
        return None
    n = tr["counters"].get("coop_score_select", 0)
    s = sum(v for name, v in tr["device_s_by_name"].items()
            if KERNEL in name)
    if not n or not s:
        return None
    return 1e3 * s / n
