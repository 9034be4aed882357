#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--n-series N]

Phases, each of which fails the run by raising:

  1. environment: the card's name and power limit, torch's version;
  2. build: the CUDA sources under src/repro_torch/kernels/csrc, one
     nvcc each, in parallel, into build/repro_torch/, with each kernel's
     registers and spills from ptxas;
  3. ragged kernels: each kernel against its plain PyTorch version at
     shapes that are not tile multiples (summary space: atol = rtol =
     1e-3; squared distances: atol = 1e-2, rtol = 1e-5; a selected id
     may differ from the plain version's only at a tie, see ties_only;
     integer inputs, ADC distances and lex_select bit-equal), K4 and K6
     up to kk = 1024, with negative tables, every id masked, and at
     B = 100, R = 2^18, where the [B, R] scores no longer fit in L2;
  4. small input: the quickstart loop at N = 4096 on the card and on the
     CPU (plain versions), answers compared;
  5. main path: the paper's in-memory loop at N = 2^20 random-walk series
     of length 256 (1 GiB of f32 on the card), 100 noisy queries,
     k = 100, leaf_cap = 256: iSAX2+, DSTree and VA+file builds, brute
     force, exact / eps / delta-eps / ng searches and exact with
     share_gathers on iSAX2+ and DSTree. Kernel launch counts are zeroed
     before and read after; every exact row must score MAP 1.000 and
     return brute force's ids, apart from swaps between ties;
  6. out-of-core path: the DSTree of phase 5 saved as f32, bf16 and pq
     stores under build/chip_smoke_stores/ (one at a time, deleted after
     use), opened with resident="summaries" and searched through a device
     cache of L // 8 leaves with the prefetcher on. f32 exact rows must
     equal the in-memory DSTree rows; the bf16 row must equal the
     in-memory search over the store's bfloat16 image; pq rows must meet
     the epsilon bound against brute force after the exact re-rank.
     Launch counts are zeroed before and read after this phase too, and
     the two PQ kernels must have run in it;
  7. kernels at the main path's shapes: each kernel against its plain
     version, timed with CUDA events beside the plain version, one
     PyTorch library call where one computes the same function, and the
     least time the card could take (bound_ms). K1-K4 and lex_select
     report their launches on the in-memory path, K5 and K6 on the
     out-of-core path. A line splits K4 and K6 into their score and
     select passes.

Prints a ``{"kernels": [...]}`` line, then ``{"ok": true, "device": ...}``
as its last line. Exits non-zero without a result when no CUDA device
is present or the package is missing.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

# H100 SXM published peaks (NVIDIA data sheet): f32 outside the tensor
# cores, and device memory bandwidth. The f32 rate counts an FMA as two
# operations, so an f32 instruction that is not an FMA issues at half it
PEAK_F32_FLOPS = 67e12
PEAK_F32_INSTR = PEAK_F32_FLOPS / 2
PEAK_BYTES = 3.35e12
# summary-space values (K1, K2)
TOL = 1e-3
# squared distances (K3, K4, searches), about 512 at the main path: IEEE
# f32 accumulation in another order stays near 5e-4, a TF32 or bf16
# product would be off by 1e-2 to 1e-1
DIST_ATOL, DIST_RTOL = 1e-2, 1e-5

KERNEL_ROWS = {
    "box_mindist": ("src/repro_torch/kernels/csrc/box_mindist.cu",
                    "src/repro/kernels/box_mindist.py:24"),
    "paa": ("src/repro_torch/kernels/csrc/paa.cu",
            "src/repro/kernels/paa.py:19"),
    "l2": ("src/repro_torch/kernels/csrc/l2_dist.cu",
           "src/repro/kernels/l2_dist.py:23"),
    "coop_score_select": ("src/repro_torch/kernels/csrc/topk.cu",
                          "src/repro/kernels/topk.py:54"),
    "pq_adc_batch": ("src/repro_torch/kernels/csrc/pq_adc.cu",
                     "src/repro/kernels/pq_adc.py:23"),
    "pq_adc_select": ("src/repro_torch/kernels/csrc/pq_adc.cu",
                      "src/repro/kernels/pq_adc_select.py:40"),
    "lex_select": ("src/repro_torch/kernels/csrc/lex_select.cu",
                   "src/repro/kernels/topk.py:32"),
}


# device cycles to hold the stream per timed launch while the host
# enqueues: 0.3 ms at the H100's clock, more than a wrapper's host time
HOLD_CYCLES_PER_REP = 600_000


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean milliseconds of fn() over reps launches, by CUDA events. The
    stream first runs a spin kernel long enough for the host to enqueue
    every launch behind it, so a kernel shorter than its wrapper's host
    time is timed on the device, not at the host's launch rate."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(HOLD_CYCLES_PER_REP * reps)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(n_bytes: float, n_ops: float,
             rate: float = PEAK_F32_FLOPS) -> tuple:
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = n_ops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def close(torch, got, want, what: str, atol: float = TOL,
          rtol: float = TOL) -> float:
    """Max abs error of got vs want; raises beyond atol + rtol * |want|."""
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)} vs "
                             f"{tuple(want.shape)}")
    finite = torch.isfinite(want)
    if not torch.equal(finite, torch.isfinite(got)):
        raise AssertionError(f"{what}: non-finite entries disagree")
    if not bool(finite.any()):
        return 0.0
    err = (got[finite] - want[finite]).abs()
    if bool((err > atol + rtol * want[finite].abs()).any()):
        raise AssertionError(f"{what}: max abs error {float(err.max())}")
    return float(err.max())


def dist_close(torch, got, want, what: str) -> float:
    return close(torch, got, want, what, DIST_ATOL, DIST_RTOL)


def ties_only(torch, got_ids, want_ids, dist64, what: str) -> int:
    """Rows of ids [B, k] (-1 = none) against the reference's: each row
    holds distinct ids, and where an id differs from the reference's at
    the same rank, the two are a tie, their true squared distances
    (``dist64(ids)``, float64, inf for -1) within the distance tolerance.
    Returns the number of such swaps."""
    s, _ = torch.sort(got_ids.long(), dim=1)
    if bool(((s[:, 1:] == s[:, :-1]) & (s[:, 1:] >= 0)).any()):
        raise AssertionError(f"{what}: an id is returned twice")
    diff = got_ids != want_ids
    if not bool(diff.any()):
        return 0
    dg, dw = dist64(got_ids), dist64(want_ids)
    gap = torch.where(diff, (dg - dw).abs(), torch.zeros_like(dg))
    if bool((gap > DIST_ATOL + DIST_RTOL * dw.abs()).any()):
        raise AssertionError(f"{what}: an id differs from the reference's "
                             "where the two are no tie")
    return int(diff.sum())


def sq_dist64(torch, q, rows, pos):
    """ids [B, k] -> float64 squared distances of q [B, n] to
    rows[pos[id]] (inf for id -1)."""

    def dist(ids):
        ok = ids >= 0
        x = rows[pos[ids.long().clamp_min(0)]].double()
        d = ((x - q.double()[:, None, :]) ** 2).sum(-1)
        return torch.where(ok, d, torch.full_like(d, float("inf")))

    return dist


def select_close(torch, got, want, q, rows, ids, what: str) -> float:
    """(d, id) selections over rows with ids: distances within the
    distance tolerance, ids the reference's apart from swaps between
    ties."""
    err = dist_close(torch, got[0], want[0], what)
    pos = torch.zeros(int(ids.max()) + 1, dtype=torch.long,
                      device=ids.device)
    ok = ids >= 0
    pos[ids[ok].long()] = torch.nonzero(ok)[:, 0]
    ties_only(torch, got[1], want[1], sq_dist64(torch, q, rows, pos), what)
    return err


def phase_ragged(torch, ops, ref) -> None:
    g = torch.Generator(device="cuda").manual_seed(0)

    def rn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g, device="cuda").to(dtype)

    for n_rows, n, l in [(1, 64, 16), (1001, 96, 8), (257, 256, 16),
                         (33, 100, 5)]:
        x = rn(n_rows, n)
        got, want = ops.paa(x, l), ref.ref_paa(x, l)
        close(torch, got, want, f"paa {n_rows}x{n}/{l}")
        if not torch.equal(got, want):
            raise AssertionError(f"paa {n_rows}x{n}/{l} is not bit-exact")
    for b, L, d in [(1, 3, 16), (5, 1000, 32), (130, 700, 8),
                    (100, 4097, 16)]:
        q, lo = rn(b, d), rn(L, d) - 1.0
        hi = lo + rn(L, d).abs()
        w = rn(d).abs() + 0.5
        got, want = ops.box_mindist(q, lo, hi, w), \
            ref.ref_box_mindist(q, lo, hi, w)
        close(torch, got, want, f"box_mindist {b}x{L}x{d}")
    for b, m, n, dt in [(1, 1, 32, torch.float32),
                        (4, 100, 256, torch.float32),
                        (130, 257, 100, torch.float32),
                        (8, 64, 1000, torch.float32),
                        (7, 300, 256, torch.bfloat16),
                        (5, 33, 24, torch.bfloat16)]:
        q, x = rn(b, n), rn(m, n, dtype=dt)
        dist_close(torch, ops.l2(q, x), ref.ref_l2(q, x),
                   f"l2 {b}x{m}x{n} {dt}")
    for b, r, n, kk, dt, kind in [
            (5, 96, 32, 7, torch.float32, ""),
            (9, 1000, 256, 200, torch.float32, ""),
            (100, 2560, 256, 256, torch.float32, ""),
            (3, 300, 64, 40, torch.bfloat16, ""),
            (6, 500, 16, 64, torch.float32, "integer"),
            (20, 4100, 16, 64, torch.float32, "integer"),
            (30, 5000, 16, 1024, torch.float32, "integer"),
            (100, 1 << 18, 256, 200, torch.float32, ""),
            (100, 1 << 18, 256, 200, torch.float32, "masked")]:
        if kind == "integer":  # exact arithmetic, ties decided by id
            q = torch.randint(-2, 3, (b, n), generator=g, device="cuda")
            rows = torch.randint(-2, 3, (r, n), generator=g, device="cuda")
            q, rows = q.float(), rows.float()
        else:
            q, rows = rn(b, n), rn(r, n, dtype=dt)
        norms = ops.row_sq_norms(rows)
        ids = torch.randperm(r, generator=g, device="cuda").to(torch.int32)
        ids[::7] = -1
        if kind == "masked":  # every slot comes back as (inf, -1)
            ids[:] = -1
        got = ops.coop_score_select(q, rows, norms, ids, kk)
        want = ref.ref_coop_score_select(q, rows, norms, ids, kk)
        what = f"coop_score_select {b}x{r}x{n} kk={kk} {dt} {kind}"
        if kind:
            if not (torch.equal(got[0], want[0])
                    and torch.equal(got[1], want[1])):
                raise AssertionError(f"{what}: not exact")
        else:
            select_close(torch, got, want, q, rows, ids, what)
        del q, rows, norms, ids, got, want
    for b, r, m, per_lane in [(1, 1, 16, False), (3, 1001, 16, False),
                              (7, 333, 16, True), (2, 4097, 8, False),
                              (5, 65, 5, True), (100, 256, 16, True)]:
        luts = torch.rand(b, m, 256, generator=g, device="cuda") * 4.0
        shape = (b, r, m) if per_lane else (r, m)
        codes = torch.randint(0, 256, shape, generator=g, device="cuda",
                              dtype=torch.uint8)
        if not torch.equal(ops.pq_adc_batch(codes, luts),
                           ref.ref_pq_adc_batch(codes, luts)):
            raise AssertionError(f"pq_adc_batch {shape} x {b} luts is not "
                                 "bit-exact")
    # K6 adds table entries left to right as its plain version does, and
    # its selection is exact: bit-equal, negative distances included
    for b, r, m, kk, kind in [(5, 96, 16, 7, ""),
                              (9, 1000, 16, 200, "integer"),
                              (100, 3000, 16, 800, "negative"),
                              (13, 5000, 16, 1024, "integer negative"),
                              (3, 400, 7, 33, "negative"),
                              (100, 1 << 18, 16, 800, "negative"),
                              (100, 1 << 18, 16, 800, "masked")]:
        luts = torch.rand(b, m, 256, generator=g, device="cuda") * 4.0
        if "negative" in kind:
            luts = luts - 2.0
        if "integer" in kind:  # small integers: many exact ties
            luts = luts.floor()
        codes = torch.randint(0, 256, (r, m), generator=g, device="cuda",
                              dtype=torch.uint8)
        ids = torch.randperm(r, generator=g, device="cuda").to(torch.int32)
        ids[::7] = -1
        if kind == "masked":
            ids[:] = -1
        got = ops.pq_adc_select(codes, luts, ids, kk)
        want = ref.ref_pq_adc_select(codes, luts, ids, kk)
        if not (torch.equal(got[0], want[0])
                and torch.equal(got[1], want[1])):
            raise AssertionError(f"pq_adc_select {b}x{r}x{m} kk={kk} {kind}: "
                                 "not bit-exact")
    # the selection alone: staged in shared memory up to 48K rows a lane,
    # read from device memory above
    for b, r, kk, kind in [(3, 50, 7, ""), (5, 3000, 1024, "integer"),
                           (100, 25600, 800, ""), (9, 5000, 100, "negative"),
                           (7, 1 << 18, 1024, "integer"),
                           (6, 70000, 1000, "masked")]:
        s = torch.rand(b, r, generator=g, device="cuda") * 512.0
        if kind == "integer":
            s = torch.randint(-3, 4, (b, r), generator=g, device="cuda")
            s = s.float()
        elif kind == "negative":
            s = torch.randn(b, r, generator=g, device="cuda")
            s[:, ::11] = -0.0
        ids = torch.randperm(r, generator=g, device="cuda").to(torch.int32)
        ids[::7] = -1
        if kind == "masked":
            ids[:] = -1
        got = ops.lex_select(s, ids, kk)
        want = ref.ref_lex_select(s, ids, kk)
        if not (torch.equal(got[0], want[0])
                and torch.equal(got[1], want[1])):
            raise AssertionError(f"lex_select {b}x{r} kk={kk} {kind}: not "
                                 "bit-exact")
    torch.cuda.synchronize()


def quickstart(torch, S, G, idx_mods, data, q, k, leaf_cap, device,
               log=lambda line: None):
    """Build the three indexes and run the guarantee taxonomy; returns
    (rows of the table, results by (index, guarantee), build seconds,
    the indexes by name, brute force's result). ``log`` gets a line as
    each step ends."""

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    builds, results, table, built = {}, {}, [], {}
    t0 = time.perf_counter()
    truth = S.brute_force(q, data, k, device=device)
    sync()
    builds["brute_force"] = time.perf_counter() - t0
    log(f"  brute force {builds['brute_force']:.1f} s")
    isax, dstree, vafile = idx_mods
    specs = {
        "isax2+": (lambda: isax.build(data, leaf_cap=leaf_cap,
                                      device=device), 1),
        "dstree": (lambda: dstree.build(data, leaf_cap=leaf_cap,
                                        device=device), 1),
        "va+file": (lambda: vafile.build(data, device=device), 64),
    }
    guarantees = {
        "exact": (G.exact(), False),
        "eps=1": (G.epsilon(1.0), False),
        "d=.99,eps=1": (G.delta_epsilon(0.99, 1.0), False),
        "ng(nprobe=4)": (G.ng(4), False),
    }
    from repro_torch.core.metrics import workload_metrics

    for iname, (make, vb) in specs.items():
        t0 = time.perf_counter()
        idx = built[iname] = make()
        sync()
        builds[iname] = time.perf_counter() - t0
        log(f"  {iname} built in {builds[iname]:.1f} s, "
            f"{idx.num_leaves} leaves, max_leaf {idx.max_leaf}")
        runs = dict(guarantees)
        if iname != "va+file":
            runs["exact+share"] = (G.exact(), True)
        for gname, (g, share) in runs.items():
            t0 = time.perf_counter()
            res = S.search(idx, q, k, g, visit_batch=vb,
                           share_gathers=share, device=device)
            sync()
            sec = time.perf_counter() - t0
            m = workload_metrics(res.ids, res.dists, truth.ids, truth.dists)
            results[(iname, gname)] = res
            log(f"  {iname} {gname}: {sec:.2f} s, {res.iterations} "
                f"iterations")
            table.append(dict(
                index=iname, guarantee=gname, map=m["map"],
                recall=m["avg_recall"], mre=m["mre"],
                leaves=float(res.leaves_visited.float().mean()),
                pct_data=100 * float(res.rows_scanned.float().mean())
                / data.shape[0],
                iterations=res.iterations, ms=sec * 1e3,
                ms_per_iter=sec * 1e3 / max(res.iterations, 1)))
    return table, results, builds, built, truth


def print_table(rows) -> None:
    hdr = (f"{'index':9s} {'guarantee':13s} {'MAP':>6s} {'recall':>7s} "
           f"{'MRE':>7s} {'leaves':>7s} {'%data':>7s} {'iters':>6s} "
           f"{'ms':>9s} {'ms/iter':>8s}")
    print(hdr)
    print("-" * len(hdr))
    for r in rows:
        print(f"{r['index']:9s} {r['guarantee']:13s} {r['map']:6.3f} "
              f"{r['recall']:7.3f} {r['mre']:7.4f} {r['leaves']:7.0f} "
              f"{r['pct_data']:6.2f}% {r['iterations']:6d} "
              f"{r['ms']:9.1f} {r['ms_per_iter']:8.3f}")


def phase_small(torch, S, G, idx_mods, randomwalk, queries) -> None:
    data = randomwalk.generate(seed=3, n_series=4096, series_len=256)
    q = queries.noisy_queries(data, 16)
    data_t = torch.as_tensor(data, device="cuda")
    dist64 = sq_dist64(torch, torch.as_tensor(q, device="cuda"), data_t,
                       torch.arange(data.shape[0], device="cuda"))
    _, gpu, _, _, _ = quickstart(torch, S, G, idx_mods, data, q, 10, 64,
                              "cuda")
    _, cpu, _, _, _ = quickstart(torch, S, G, idx_mods, data, q, 10, 64,
                              "cpu")
    for key, rg in gpu.items():
        # only exact answers must agree: an approximate row's stopping
        # point depends on the last bits of its distances, and VA+file's
        # cells on the last bits of the card's or the CPU's FFT
        if not key[1].startswith("exact"):
            continue
        rc = cpu[key]
        # squared distances: a query that is a copy of a row sits at 0,
        # where the square root magnifies rounding noise
        dist_close(torch, rg.dists.cpu() ** 2, rc.dists ** 2,
                   f"small {key} squared dists")
        ties_only(torch, rg.ids, rc.ids.cuda(), dist64,
                  f"small {key} card vs CPU")


def kernel_rows(torch, ops, ref, build, data_t, q_t, idx, vaf, k, counts,
                pq_in):
    """Each kernel at the main path's shapes: its error against the plain
    version, then the kernel's, the plain version's and a library call's
    times, and the least time the card could take. Prints the split of
    K4 and K6 into their score and select passes."""
    F = torch.nn.functional
    rows = []

    def add(name, err, kernel, plain, n_bytes, n_ops, library=None,
            reps=10, rate=PEAK_F32_FLOPS):
        src, replaces = KERNEL_ROWS[name]
        bnd, by = bound_ms(n_bytes, n_ops, rate)
        rows.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=counts[name], max_abs_err=err,
            ms=cuda_ms(torch, kernel, reps),
            plain_ms=cuda_ms(torch, plain, max(2, reps // 5)),
            bound_ms=bnd, bound_by=by,
            library_ms=None if library is None
            else cuda_ms(torch, library, reps)))

    # K1: the VA+file filter pass, the largest box_mindist call
    a = (vaf.summarize_queries(q_t).contiguous(), vaf.box_lo, vaf.box_hi,
         vaf.weights)
    b, d = a[0].shape
    L = vaf.box_lo.shape[0]
    add("box_mindist",
        close(torch, ops.box_mindist(*a), ref.ref_box_mindist(*a),
              "box_mindist main"),
        lambda: ops.box_mindist(*a), lambda: ref.ref_box_mindist(*a),
        4 * (b * d + 2 * L * d + d + b * L), 7 * b * L * d,
        rate=PEAK_F32_INSTR)

    # K2: the iSAX build's summary of the whole collection
    n_rows, n = data_t.shape
    l = 16
    add("paa",
        close(torch, ops.paa(data_t, l), ref.ref_paa(data_t, l), "paa main"),
        lambda: ops.paa(data_t, l), lambda: ref.ref_paa(data_t, l),
        4 * (n_rows * n + n_rows * l), n_rows * (n + l),
        rate=PEAK_F32_INSTR,
        library=lambda: F.avg_pool1d(data_t[:, None, :], n // l))

    # K3: brute force over the collection; the library call is cdist's
    # matmul form, which adds a square root
    b = q_t.shape[0]
    add("l2",
        dist_close(torch, ops.l2(q_t, data_t), ref.ref_l2(q_t, data_t),
                   "l2 main"),
        lambda: ops.l2(q_t, data_t), lambda: ref.ref_l2(q_t, data_t),
        4 * (b * n + n_rows * n + b * n_rows),
        2 * b * n_rows * n + 2 * (b + n_rows) * n + 3 * b * n_rows,
        library=lambda: torch.cdist(q_t, data_t,
                                    compute_mode="use_mm_for_euclid_dist"),
        reps=5)

    # K4: one cooperative iteration on iSAX2+ (every lane pools a leaf)
    r = b * idx.max_leaf
    kk = min(2 * k, r)
    a = (q_t, idx.data[:r].contiguous(), idx.row_norms[:r].contiguous(),
         idx.ids[:r].contiguous(), kk)
    add("coop_score_select",
        select_close(torch, ops.coop_score_select(*a),
                     ref.ref_coop_score_select(*a), q_t, a[1], a[3],
                     "coop main"),
        lambda: ops.coop_score_select(*a),
        lambda: ref.ref_coop_score_select(*a),
        4 * (b * n + r * n + 2 * r) + 8 * b * kk,
        2 * b * r * n + 2 * b * n + 3 * b * r)

    # lex_select at K4's shape: the scores of that iteration, selected
    q4, rows4, norms4, ids4, kk4 = a
    s4 = ops.sq_l2(q4, rows4, norms4)
    got, want = ops.lex_select(s4, ids4, kk4), ref.ref_lex_select(s4, ids4,
                                                                 kk4)
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise AssertionError("lex_select main: not bit-exact")
    add("lex_select", 0.0, lambda: ops.lex_select(s4, ids4, kk4),
        lambda: ref.ref_lex_select(s4, ids4, kk4),
        4 * (b * r + r) + 8 * b * kk4, b * r, rate=PEAK_F32_INSTR)
    score4 = build.library("topk").coop_score_f32
    stream = build.stream(q4)
    split = {"K4 score": cuda_ms(torch, lambda: score4(
        q4.data_ptr(), rows4.data_ptr(), norms4.data_ptr(), s4.data_ptr(),
        b, r, n, stream), 10)}
    split["K4 select (kk=%d)" % kk4] = rows[-1]["ms"]

    # K5: one query's ADC scan over the whole pq payload; the library
    # form is two calls, a gather over the table and a sum
    codes, luts = pq_in
    m_rows, m = codes.shape
    kq = luts.shape[2]
    lut1 = luts[:1].contiguous()
    got = ops.pq_adc_batch(codes, lut1)
    if not torch.equal(got, ref.ref_pq_adc_batch(codes, lut1)):
        raise AssertionError("pq_adc_batch main: not bit-exact")
    flat = (codes.long() + torch.arange(m, device="cuda") * kq)
    table = lut1.reshape(1, m * kq).expand(m_rows, -1)
    add("pq_adc_batch", 0.0,
        lambda: ops.pq_adc_batch(codes, lut1),
        lambda: ref.ref_pq_adc_batch(codes, lut1),
        m_rows * m + 4 * m * kq + 4 * m_rows, m_rows * m,
        rate=PEAK_F32_INSTR,
        library=lambda: torch.gather(table, 1, flat).sum(1))

    # K6: one cooperative pq iteration of the out-of-core DSTree search
    # (every lane pools a leaf of codes; kk = 2 k rerank)
    r = b * idx.max_leaf
    kk = min(2 * 4 * k, r)
    pool = codes[:r].contiguous()
    ids = torch.arange(r, dtype=torch.int32, device="cuda")
    a = (pool, luts, ids, kk)
    got, want = ops.pq_adc_select(*a), ref.ref_pq_adc_select(*a)
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise AssertionError("pq_adc_select main: not bit-exact")
    add("pq_adc_select", 0.0,
        lambda: ops.pq_adc_select(*a), lambda: ref.ref_pq_adc_select(*a),
        r * m + 4 * b * m * kq + 4 * r + 8 * b * kk, b * r * m,
        rate=PEAK_F32_INSTR)
    s6 = ops.pq_adc_batch(pool, luts)
    split["K6 score"] = cuda_ms(torch, lambda: ops.pq_adc_batch(pool, luts),
                                10)
    split["K6 select (kk=%d)" % kk] = cuda_ms(
        torch, lambda: ops.lex_select(s6, ids, kk), 10)
    print("score/select split (ms): " + ", ".join(
        f"{name} {ms:.4f}" for name, ms in split.items()))
    return rows


def print_ooc_table(rows) -> None:
    hdr = (f"{'codec':5s} {'guarantee':14s} {'MAP':>6s} {'recall':>7s} "
           f"{'MRE':>7s} {'leaves':>7s} {'%data':>7s} {'iters':>6s} "
           f"{'ms':>9s} {'ms/iter':>8s} {'read MB':>9s} {'h2d MB':>8s} "
           f"{'hit':>5s}")
    print(hdr)
    print("-" * len(hdr))
    for r in rows:
        print(f"{r['codec']:5s} {r['guarantee']:14s} {r['map']:6.3f} "
              f"{r['recall']:7.3f} {r['mre']:7.4f} {r['leaves']:7.0f} "
              f"{r['pct_data']:6.2f}% {r['iterations']:6d} "
              f"{r['ms']:9.1f} {r['ms_per_iter']:8.3f} "
              f"{r['bytes_read'] / 1e6:9.1f} {r['bytes_h2d'] / 1e6:8.1f} "
              f"{r['hit_rate']:5.3f}")


def phase_ooc(torch, S, G, index, q, truth, mem, k, root: Path):
    """Save the DSTree as f32, bf16 and pq stores and answer the queries
    out of core. Returns (table rows, store sizes and save seconds by
    codec, (pq codes on the card, the queries' ADC tables))."""
    from repro_torch.core.index import FrozenIndex
    from repro_torch.core.metrics import workload_metrics
    from repro_torch.core.summaries.pq import adc_lut_batch

    runs = {
        "f32": [("exact", G.exact(), False), ("exact+share", G.exact(), True)],
        "bf16": [("d=.99,eps=1", G.delta_epsilon(0.99, 1.0), False)],
        "pq": [("eps=1", G.epsilon(1.0), False),
               ("eps=1+share", G.epsilon(1.0), True),
               ("d=.99,eps=1+sh", G.delta_epsilon(0.99, 1.0), True)],
    }
    table, saved, pq_in = [], {}, None
    n_series = index.n_total
    for codec, cases in runs.items():
        d = root / codec
        t0 = time.perf_counter()
        index.save(str(d), codec=codec)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        sizes = {f: os.path.getsize(d / f) for f in sorted(os.listdir(d))}
        saved[codec] = (sec, sizes)
        print(f"  saved {codec} in {sec:.1f} s: " + ", ".join(
            f"{f} {b / 2**20:.1f} MiB" for f, b in sizes.items()))
        store = FrozenIndex.load(str(d), resident="summaries")
        for gname, g, share in cases:
            t0 = time.perf_counter()
            out = S.search_ooc(store, q, k, g, share_gathers=share)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            res, st = out.result, out.stats
            what = f"ooc {codec} {gname}"
            print(f"  {what}: {sec:.2f} s, {st.iterations} iterations")
            if codec == "f32":
                want = mem[("dstree", gname)]
                for f in ("ids", "leaves_visited", "rows_scanned"):
                    if not torch.equal(getattr(res, f), getattr(want, f)):
                        raise AssertionError(f"{what}: {f} differ from the "
                                             "in-memory DSTree search")
            elif codec == "bf16":
                want = S.search(FrozenIndex.load(str(d)), q, k, g)
                for f in ("ids", "dists", "leaves_visited", "rows_scanned"):
                    if not torch.equal(getattr(res, f), getattr(want, f)):
                        raise AssertionError(f"{what}: {f} differ from the "
                                             "in-memory search of the "
                                             "bfloat16 image")
            else:
                ok = res.dists <= (1 + g.epsilon) * truth.dists \
                    * (1 + 1e-4) + 1e-4
                share_ok = float(ok.float().mean())
                if (g.delta == 1.0 and not bool(ok.all())) or share_ok < 0.9:
                    raise AssertionError(f"{what}: the epsilon bound holds "
                                         f"for {share_ok:.3f} of the ranks")
            if res.dists.shape != (q.shape[0], k) or not bool(
                    torch.isfinite(res.dists[:, 0]).all()):
                raise AssertionError(f"{what}: wrong shape or no finite "
                                     "nearest neighbour")
            m = workload_metrics(res.ids, res.dists, truth.ids, truth.dists)
            table.append(dict(
                codec=codec, guarantee=gname, map=m["map"],
                recall=m["avg_recall"], mre=m["mre"],
                leaves=float(res.leaves_visited.float().mean()),
                pct_data=100 * float(res.rows_scanned.float().mean())
                / n_series,
                iterations=res.iterations, ms=sec * 1e3,
                ms_per_iter=sec * 1e3 / max(res.iterations, 1),
                bytes_read=st.bytes_read, bytes_h2d=st.bytes_h2d,
                hit_rate=st.hit_rate))
        if codec == "pq":
            codes = torch.as_tensor(np.array(store.mmap), device="cuda")
            pq_in = (codes, adc_lut_batch(store.codebook,
                                          torch.as_tensor(q, device="cuda")))
        del store
        shutil.rmtree(d)
    return table, saved, pq_in


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-series", type=int, default=1 << 20)
    args = ap.parse_args()
    sys.stdout.reconfigure(line_buffering=True)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root / "src"))
    from repro_torch.core import guarantees as G
    from repro_torch.core import search as S
    from repro_torch.core.indexes import dstree, isax, vafile
    from repro_torch.data import queries, randomwalk
    from repro_torch.kernels import build, ops, ref

    # exact answers compare f32 distances: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    logs = build.build_all()
    print(f"build: {len(logs)} kernels in {time.perf_counter() - t0:.1f} s "
          f"into {build.BUILD_DIR}")
    for name, log in logs.items():
        entry = ""
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif "registers" in line or "spill" in line:
                print(f"  ptxas {name} {entry}: {line.split(':', 1)[-1]}"
                      .rstrip())

    t0 = time.perf_counter()
    phase_ragged(torch, ops, ref)
    print(f"ragged kernel checks: ok ({time.perf_counter() - t0:.1f} s)")

    idx_mods = (isax, dstree, vafile)
    t0 = time.perf_counter()
    phase_small(torch, S, G, idx_mods, randomwalk, queries)
    print(f"small input, card vs CPU: ok ({time.perf_counter() - t0:.1f} s)")

    n_series, k = args.n_series, 100
    t0 = time.perf_counter()
    data = randomwalk.generate(seed=11, n_series=n_series, series_len=256)
    q = queries.noisy_queries(data, 100)
    print(f"data: {n_series} x 256 random-walk series, 100 queries "
          f"({time.perf_counter() - t0:.1f} s on the host)")

    wrappers = {"box_mindist": ops.box_mindist, "paa": ops.paa,
                "l2": ops.l2, "coop_score_select": ops.coop_score_select,
                "lex_select": ops.lex_select,
                "pq_adc_batch": ops.pq_adc_batch,
                "pq_adc_select": ops.pq_adc_select}
    for fn in wrappers.values():
        fn.launches = 0
    table, results, builds, built, truth = quickstart(
        torch, S, G, idx_mods, data, q, k, 256, "cuda", log=print)
    counts = {name: fn.launches for name, fn in wrappers.items()}
    print_table(table)
    print("build seconds: " + ", ".join(
        f"{name} {sec:.1f}" for name, sec in builds.items()))
    print(f"launches on the main path: {counts}")
    data_t = torch.as_tensor(data, device="cuda")
    q_t = torch.as_tensor(q, device="cuda")
    dist64 = sq_dist64(torch, q_t, data_t,
                       torch.arange(n_series, device="cuda"))
    for r in table:
        if not r["guarantee"].startswith("exact"):
            continue
        what = f"{r['index']} {r['guarantee']}"
        if f"{r['map']:.3f}" != "1.000":
            raise AssertionError(f"{what}: MAP {r['map']} on an exact row")
        swaps = ties_only(torch, results[(r["index"], r["guarantee"])].ids,
                          truth.ids, dist64, what)
        print(f"  {what}: ids are brute force's ({swaps} swaps of ties)")
    for res in results.values():
        if res.dists.shape != (100, k) or not bool(
                torch.isfinite(res.dists[:, 0]).all()):
            raise AssertionError("search output has the wrong shape or "
                                 "no finite nearest neighbour")
    missing = [name for name, c in counts.items() if c == 0
               and not name.startswith("pq_")]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{missing}")

    # the out-of-core path, with its own launch counts
    root = Path(build.BUILD_DIR).parent / "chip_smoke_stores"
    shutil.rmtree(root, ignore_errors=True)
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    try:
        ooc_table, saved, pq_in = phase_ooc(
            torch, S, G, built["dstree"], q, truth, results, k, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    ooc_counts = {name: fn.launches for name, fn in wrappers.items()}
    print(f"out-of-core DSTree ({time.perf_counter() - t0:.1f} s, cache "
          f"of L // 8 leaves, prefetcher on):")
    print_ooc_table(ooc_table)
    print(f"launches on the out-of-core path: {ooc_counts}")
    missing = [name for name in ("pq_adc_batch", "pq_adc_select")
               if ooc_counts[name] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the out-of-core "
                             f"path: {missing}")
    counts.update({name: ooc_counts[name]
                   for name in ("pq_adc_batch", "pq_adc_select")})

    rows = kernel_rows(torch, ops, ref, build, data_t, q_t, built["isax2+"],
                       built["va+file"], k, counts, pq_in)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
