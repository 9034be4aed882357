"""lex_select.ms_per_launch: the device time of the exact selection in
the profiled stretch, every kernel whose name holds ``lex_select``
(``repro_torch/kernels/csrc/lex_select.cu``: the lane kernel, or the
split path's chunk and key kernels), over the calls the program counted
there (ms).

The calls are ``kernels.lex_select{path}`` in ``repro_torch.obs.
REGISTRY``, summed over its paths; the program counts a call only while
a span sink is on, which in a run is the profiled stretch alone. Absent
where the program does not count the calls or no selection ran on the
device."""

NAME = "lex_select"


def read(rec):
    tr = rec.trace
    if not tr:
        return None
    from repro_torch.obs import REGISTRY

    calls = sum(REGISTRY.snapshot("kernels.lex_select").values())
    s = sum(v for name, v in tr["device_s_by_name"].items() if NAME in name)
    if not calls or not s:
        return None
    return 1e3 * s / calls
