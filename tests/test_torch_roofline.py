"""repro_torch.launch.analytic and .roofline against the JAX package's
(src/repro/launch/analytic.py, roofline.py): the FLOP and byte models,
MODEL_FLOPS and the collectives' wire bytes are plain arithmetic, so
every number must equal the reference's exactly (== on floats), over
all ten full configs and the four shapes. Both reference modules import
no device state at top level. Then the port's own report (the H100
terms, the memory it derives, the roofline share of a measurement) and
the refusal to measure without a card."""

import pytest
import torch

from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.configs import shape_applicable as j_shape_applicable
from repro.launch import analytic as j_analytic
from repro.launch import roofline as j_roofline
from repro_torch.configs import (ARCH_IDS, SHAPES, get_config,
                                 shape_applicable)
from repro_torch.launch import analytic, roofline

CELLS = [(a, s) for a in ARCH_IDS for s in SHAPES]


@pytest.mark.parametrize("arch,shape", CELLS,
                         ids=[f"{a}-{s}" for a, s in CELLS])
def test_analytic_models_equal_the_reference(arch, shape):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    sh, jsh = SHAPES[shape], J_SHAPES[shape]
    ok, reason = shape_applicable(cfg, sh)
    assert (ok, reason) == j_shape_applicable(jcfg, jsh)
    if not ok:
        return
    n, active = cfg.param_count(), cfg.active_param_count()
    assert (n, active) == (jcfg.param_count(), jcfg.active_param_count())
    assert roofline.model_flops(cfg, sh, active) \
        == j_roofline.model_flops(jcfg, jsh, active)
    for accum in (1, 4):
        for remat in (True, False):
            got = analytic.flops_model(cfg, sh, grad_accum=accum,
                                       remat=remat)
            want = j_analytic.flops_model(jcfg, jsh, grad_accum=accum,
                                          remat=remat)
            assert got == want, (accum, remat)
            for opt_bpp in (4, 8):
                kw = dict(param_count=n, grad_accum=accum,
                          opt_bytes_per_param=opt_bpp, remat=remat)
                assert analytic.bytes_model(cfg, sh, **kw) \
                    == j_analytic.bytes_model(jcfg, jsh, **kw), kw


@pytest.mark.parametrize("op", ["all-reduce", "all-gather",
                                "reduce-scatter", "all-to-all",
                                "collective-permute", "send"])
def test_wire_bytes_equal_the_reference(op):
    for g in (1, 2, 4, 8):
        for size in (0, 1, 4096, 3 * 2 ** 30 + 7):
            assert roofline._wire_bytes(op, size, g) \
                == j_roofline._wire_bytes(op, size, g), (g, size)


def test_h100_constants():
    assert roofline.PEAK_FLOPS == 989e12
    assert roofline.PEAK_F32_FLOPS == 67e12
    assert roofline.HBM_BW == 3.35e12
    assert roofline.NVLINK_BW == 450e9
    assert 80e9 <= roofline.HBM_BYTES < 80 * 2 ** 30


def test_report_terms_memory_and_roofline_share():
    mem = {"argument_bytes": 10 * 2 ** 30, "output_bytes": 2 ** 20,
           "temp_bytes": 2 ** 30}
    rep = roofline.roofline_report(
        world=1, model_flops_global=5e11, analytic_flops_global=1e12,
        analytic_bytes_global=6.7e9, memory=mem, raw_flops=3e12,
        steps_hint="decode")
    t = rep["terms_seconds"]
    assert t == {"compute": 1e12 / 989e12, "memory": 6.7e9 / 3.35e12,
                 "collective": 0.0}
    assert rep["bottleneck"] == "memory"
    assert rep["useful_flops_ratio"] == 0.5
    assert rep["raw_counted_flops_per_device"] == 3e12
    assert rep["raw_counted_bytes_per_device"] is None
    assert rep["n_collectives"] == 0 and rep["wire_bytes_per_device"] == 0
    m = rep["memory_analysis"]
    assert m["live_bytes"] == 11 * 2 ** 30 + 2 ** 20
    assert m["fits_hbm"] and m["hbm_frac"] == m["live_bytes"] \
        / roofline.HBM_BYTES
    assert "roofline_share" not in rep
    measured = {"measured_seconds": 0.004, "busy_seconds": 0.003,
                "idle_share": 0.25, "kernels": 7}
    rep = roofline.roofline_report(
        world=1, model_flops_global=5e11, analytic_flops_global=1e12,
        analytic_bytes_global=6.7e9, memory=dict(mem, temp_bytes=None),
        measured=measured)
    assert rep["roofline_share"] == (6.7e9 / 3.35e12) / 0.004
    assert rep["roofline_bound"] == "memory"
    assert rep["kernels"] == 7
    assert rep["memory_analysis"]["live_bytes"] == 10 * 2 ** 30 + 2 ** 20
    # the reference's report keys, with the counted numbers renamed
    ref_keys = {"world", "flops_per_device", "bytes_per_device",
                "wire_bytes_per_device", "wire_bytes_by_kind",
                "terms_seconds", "bottleneck", "model_flops_global",
                "useful_flops_ratio", "n_collectives", "top_collectives",
                "memory_analysis", "note"}
    assert ref_keys <= set(rep)


def test_no_measurement_without_the_card():
    x = torch.zeros(4)
    with pytest.raises(ValueError, match="on the card"):
        roofline.profile_device(lambda: x + 1, inputs=(x,))
    with pytest.raises(ValueError, match="on the card"):
        roofline.profile_device(lambda: None, inputs={"a": [x]})
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            roofline.profile_device(lambda: None)


def test_collectives_wait_for_the_multi_gpu_item():
    """The multi-GPU item has come: the collectives are recorded from the
    run (``CollectiveRecorder``) and ``parse_collectives`` prices each
    record as the reference prices the same op read from its HLO."""
    hlo = ("  %ar = f32[1024]{0} all-reduce(f32[1024]{0} %x), "
           "replica_groups=[2,4]<=[8], to_apply=%add\n"
           "  %ag = bf16[64,32]{1,0} all-gather(bf16[16,32]{1,0} %y), "
           "replica_groups=[2,4]<=[8], dimensions={0}\n"
           "  %rs = f32[8]{0} reduce-scatter(f32[64]{0} %z), "
           "replica_groups=[1,8]<=[8], dimensions={0}, to_apply=%add\n")
    want = j_roofline.parse_collectives(hlo, 8)
    got = roofline.parse_collectives(
        [("all-reduce", 4096, 4), ("all-gather", 4096, 4),
         ("reduce-scatter", 32, 8)], 8)
    assert [(c.op, c.bytes_result, c.group_size, c.wire_bytes)
            for c in got] == [(c.op, c.bytes_result, c.group_size,
                               c.wire_bytes) for c in want]
    assert roofline.parse_collectives([], 8) == []
