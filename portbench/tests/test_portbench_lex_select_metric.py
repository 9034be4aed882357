"""The selection's per-layer metric, ``lex_select.ms_per_launch``: its
reader over the device trace and the program's ``kernels.lex_select``
counter, and nothing read from a program without the counter or from a
run that kept no device busy."""

import pytest

from portbench.bench.harness import Record
from portbench.bench.spec import Spec
from repro_torch import obs

METRIC = "lex_select.ms_per_launch"
SPLIT = {
    "(anonymous namespace)::lex_select_chunk_kernel(float const*)": 0.07,
    "void (anonymous namespace)::lex_select_keys_kernel<true>(int)": 0.01,
    "void (anonymous namespace)::lex_select_kernel<true, false>()": 0.002,
    "void gemm::l2_tile_kernel<float, true>(float const*)": 0.5,
}


def _rec(by_name=None, busy=1.0):
    """A reduced profiled stretch whose device ran the kernels by_name."""
    return Record({}, {}, {}, {}, 1.0, [], [], {},
                  {"busy_s": busy, "window_s": 2.0, "iterations": 32,
                   "device_s_by_name": dict(by_name or {}), "counters": {}})


@pytest.fixture
def registry(monkeypatch):
    """A private registry in the program's place."""
    reg = obs.MetricsRegistry()
    monkeypatch.setattr(obs, "REGISTRY", reg)
    return reg


def test_the_reader_divides_the_selection_s_time_by_its_calls(registry):
    """Every kernel named lex_select* (the split path's two and the lane
    kernel), and no other, over the calls counted under both paths."""
    registry.counter("kernels.lex_select", path="split").inc(150)
    registry.counter("kernels.lex_select", path="lane").inc(10)
    read = Spec().reader(METRIC)
    assert read(_rec(SPLIT)) == pytest.approx(1e3 * 0.082 / 160)


@pytest.mark.parametrize("by_name, busy", [
    (SPLIT, 1.0),  # the parent: a busy device, no counter
    ({}, 0.0),     # the CPU: no device operation at all
], ids=["no_counter", "no_device"])
def test_the_reader_reads_nothing_without_the_counter(registry, by_name,
                                                      busy):
    """The parent program has no counter: no value, and nothing raised."""
    assert Spec().reader(METRIC)(_rec(by_name, busy)) is None


def test_the_reader_reads_nothing_without_a_selection_on_the_device(
        registry):
    """Calls counted, but no kernel named lex_select ran on the device."""
    registry.counter("kernels.lex_select", path="split").inc(150)
    read = Spec().reader(METRIC)
    assert read(_rec({"void gemm::l2_tile_kernel<float, true>()": 0.5})) \
        is None
    assert read(_rec({}, busy=0.0)) is None
