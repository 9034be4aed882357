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
     integer inputs, ADC distances, lex_select and boxes wider than 32
     dims bit-equal), K4 up to kk = 2000, K6 up to 1200 and lex_select
     up to 30000 (past its sort in shared memory), with negative tables,
     every id masked, and at B = 100, R = 2^18, where the [B, R] scores
     no longer fit in L2; K4 also reading its slots through a row index
     with whole 128-slot runs masked, at B = 9 to 257; K1 at D = 33 to
     100, K3 at the baselines' shapes;
  4. small input: the quickstart loop at N = 4096 on the card and on the
     CPU (plain versions), answers compared; then share_gathers at
     k = 600, an iSAX2+ of 48 segments, and the four vector baselines
     (each queried on one index built on the card, on the card and on
     the CPU; HNSW's adjacency built on both);
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
  7. vector baselines: HNSW, IMI, SRS and QALSH built on the main path's
     data and asked its queries with the settings of the paper's
     in-memory figure (benchmarks/bench_query_memory.py), scored against
     brute force; recall must grow with efs and nprobe, IMI's re-rank
     must not lower MAP or raise MRE, SRS must scan no more at delta 0.5
     than at 0.99. Launch counts are zeroed before and read after; K3,
     K5 and lex_select must have run. Each kernel's inputs on this path
     (the first call at each shape, in each build and each method's
     queries) are recorded and, after it, held against the plain
     version: K3 within the distance tolerance, K5 and lex_select
     bit-equal;
  8. sharded engine: the main path's data range-sharded into 4 DSTree
     shards (leaf_cap 256, one global histogram), built on the card and
     spilled as f32 stores with 2 replicas under
     build/chip_smoke_stores/engine/ (deleted after). Resident rows
     (exact, eps, delta-eps, ng, exact with sync_bsf, exact with
     share_gathers: exact rows MAP 1.000 and brute force's ids up to
     ties; sync_bsf the unsynced answer with no more leaves visited);
     the spill through open_spill, shard after shard (rows equal to
     the resident rows in ids, distances, leaves and rows); fault rows
     (the owner copy of a shard killed: failover, the same answer; a
     shard lost on every copy: degraded, the exact answer over the
     surviving rows, effective_delta < 1; an owner stalled past its
     deadline: failover, the same answer; every shard lost: ShardLost);
     one pq spill meeting the epsilon bound with a MAP no lower than the
     single pq store's of phase 6. A row with no injected fault must see
     no retry, failover or lost shard. Launch counts are zeroed before
     and read after; every kernel but K2 must have run. Each kernel's
     inputs on this path (the first call at each shape, in each build
     and row) are held against the plain version after it: K1 and K4
     and K3 (the survivors' brute force) within their tolerances, K5,
     K6 and lex_select bit-equal;
  9. streaming ingest on the engine phase's engines (resident, the f32
     spill opened again, the pq spill): 4 batches of 8192 fresh random
     walks (seed 12), compacted into a segment after each of the first
     three, the fourth left in the memtable; 1024 base ids inserted
     again with new rows; deletes of each query's 5 nearest base rows,
     a whole leaf (the one holding query 0's nearest), 8192 random base
     ids, 512 ids of the first segment and 256 of the memtable. Resident exact, eps, delta-eps, ng and exact with
     share_gathers, spilled f32 eps and ng, pq delta-eps with share, each
     against brute force over the live rows (exact rows its ids up to
     ties, epsilon rows within their bound, every returned id live at its
     live row's distance, so no deleted or superseded copy surfaces); the
     spilled eps row equal to the resident one; the resident exact row
     against a rebuild from scratch over the live rows (ids up to ties,
     bit-equal distances counted); a fresh row asked as a query finds
     itself; a daemon (auto_compact, delta_max_rows 8192) publishes a
     segment within 120 s. Launch counts are zeroed before and read
     after; every kernel but K2 must have run, and the path's kernel
     inputs are held against the plain versions;
  10. the serving front on the ingest phase's engines (the resident one
     with its write tier, the f32 spill opened again, the pq spill):
     F, the resident engine's median exact time on 8 queries, scales the
     deadline mix (none, 1.6 F, 0.8 F, 0.2 F: the exact, exact,
     delta-epsilon and ng(26) tiers); R0 is the static front's rate on 16
     requests queued at once. Open-loop points at 1 and 4 x R0 on the
     static front (Scheduler.run_retrieval on one server thread) and on
     ServeFront (depth cap 64), a burst of 96 back to back (cap 32), the
     spill, share_gathers on the resident engine and on the pq spill
     (whose top tier is eps = 1), then a write point (inserts, deletes
     and probes through the write lane). Every request is answered once
     or rejected with queue_full; exact answers are brute force's over
     the live rows up to ties; the burst rejects and sheds one tier; each
     probe finds its row and no answer holds an id deleted before its
     submit (SERVE_POINTS and WRITE_* hold the counts). Concurrent
     queries from 6 threads (6 plans of 2 queries: exact, eps = 1,
     delta-epsilon, ng) equal serial ones bit for bit on the resident
     engine and the spill; one traced spill group's
     span tree carries its OocStats' bytes_read exactly and writes a
     Chrome trace under build/. Latencies come from the port's
     Histogram, numpy's quantiles beside them. Launch counts are zeroed
     before and read after; K1, K4, lex_select and K6 must have run, and
     the path's kernel inputs are held against the plain versions;
  11. the LLM substrate: gemma2-2b at the full width and depth of
     configs/gemma2_2b.py, bf16 weights drawn on the card from a seed; its
     parameter count and bytes must be the reference's (2,614,341,888 and
     5,229,167,616). One block (local, then global) at full width in f32
     on the card (TF32 off) against the CPU on the same weights, prefill
     of 2 prompts of 64 tokens and one decode step, at atol = rtol =
     1e-3, and in bf16 on the card against f32 on the CPU at
     LLM_BF16_VS_F32. At full depth in bf16: an 8192-token prefill down
     the blockwise path (the local layers slide past their 4096 window)
     against the dense path forced, then 32 decode steps from its cache
     against a full prefill at their positions, at LLM_BF16_PATHS, every
     logit finite. Prefill and decode timed by CUDA events beside their
     bounds and the device's busy time in one profiled call. Then both
     fronts of launch/serve.py at full width over the serving phase's
     resident engine (its live rows after the write point; 16 requests,
     prompts of 32-1024 tokens, 32 new tokens, SERVE_MIX's deadlines in
     F, every group with share_gathers) and the flow of
     examples/retrieval_serving.py (4096 walks of 128 embedded by the
     mean final hidden state, a bf16-spilled DSTree engine over the 2304
     dims, 8 requests): every request answered once or rejected, its
     tokens its max_new_tokens, exact answers brute force's up to ties,
     the two fronts' exact answers the same tokens and ids. Launch counts
     are zeroed before and read after; K1, K4, lex_select and K3 must
     have run, and the path's kernel inputs are held against the plain
     versions;
  12. the MoE, SSM and hybrid families at full width in bf16 (seed 21),
     one model at a time beside the serving phase's engines:
     deepseek-moe-16b (28 of 28 layers), mamba2-370m (48 of 48),
     jamba-v0.1-52b (16 of 32) and dbrx-132b (4 of 40), each one's
     parameter count and bytes the reference's at that depth (FAM).
     Sub-stacks at full width in f32 on the card (TF32 off) against the
     CPU at 2 x 512 tokens, prefill and one decode step, at atol = rtol =
     1e-3, with the routed ids equal, and in bf16 against the f32 CPU at
     FAM_BF16_VS_F32: deepseek's first layer and one MoE block, one
     mamba2 layer, jamba's (mamba, dense), (mamba, moe) and (attn, dense)
     alone. At full depth, capacity factor 8.0: an 8192-token prefill and
     32 decode steps (dbrx: 512 and 8) against one full forward over
     both, at FAM_PATHS, every logit finite; the dropped fraction at the
     published 1.25 and the dt values the prefill clipped are reported.
     Prefill 8 x 512 and 1 x 8192 and decode at batch 1, 8 and 32 with a
     2048-token cache timed beside their bounds (a decode step reads the
     experts its tokens route to) and one profiled call's busy time.
     Then deepseek behind launch/serve.py's static front over the
     resident engine (one group of 8 requests, k = 10, 32 new tokens):
     every request answered once, exact answers brute force's. Launch
     counts are zeroed before and read after; K1, K4, lex_select and K3
     must have run;
  13. the encoder-decoder family: seamless-m4t-medium at the full width
     and depth of configs/seamless_m4t_medium.py (12 + 12 layers, d_model
     1024, vocab 256206, 1024 frames), bf16 weights drawn on the card
     from seed 22; its parameter count and bytes the reference's
     (ENC_PARAMS). One encoder and one decoder layer at full width in
     f32 on the card (TF32 off) against the CPU: encode, prefill of
     ENC_BLOCK prompts x tokens over every frame with its cross cache,
     one decode step; and encode + decode_train over ENC_CUT layers
     each, at atol = rtol = ENC_F32_TOL; bf16 on the card against the
     f32 CPU reported and held at LLM_BF16_VS_F32. Prefill 8 x 512 and
     1 x 8192 decoder tokens over 1024 frames (the self attention
     blockwise past 2048, the cross attention dense) and decode at batch
     1, 8 and 32 with a 2048-token cache, timed beside their bounds and
     one profiled call's busy time. generate(frames=) of ENC_GEN_NEW
     tokens after an ENC_GEN_PROMPT-token prompt against one full
     forward over both: logits at LLM_BF16_PATHS and the share of steps
     whose argmax agrees. No kernel of the port lies on this path
     (launch counts zeroed before, read after: all 0);
  14. training, after the engines are closed: (a) the flow of
     examples/train_embedder.py at its own settings (minitron-8b's smoke
     config, 300 steps, batch 8, seq 64, a checkpoint every 50 steps, a
     fault injected at step 150) through launch/train.fit on the card,
     with torch.use_deterministic_algorithms on for it alone: one
     restart, the mean loss of the last 5 steps at least 0.1 below the
     first 5, every kept checkpoint passing its sha256 check, and the
     losses and the final parameters equal to an uninterrupted run's bit
     for bit; (b) one train step of gemma2-2b's first block (local, then
     global) with the embedding and the softcapped logits at full width
     in f32 on the card against the CPU at 1 x 64 tokens: the loss, the
     global norm and every gradient leaf at TRAIN_GRAD_TOL relative to
     the leaf's largest magnitude, and optimizer.apply given the same
     gradients at TRAIN_APPLY_TOL; (c) AdamW steps at full width
     (TRAIN_FULL: gemma2-2b 1 x 4096 at full depth, seamless-m4t-medium
     2 x 4096 over 1024 frames, mamba2-370m 2 x 4096, deepseek-moe-16b 4
     of 28 layers at 1 x 4096), each timed by CUDA events beside its
     bound (3 x the forward's operations; recomputation not counted),
     one profiled step's busy time and the peak memory allocated, every
     loss and gradient norm finite. No kernel of the port lies on this
     path either (all 0);
  15. the roofline tooling (src/repro_torch/launch/), after the engines
     are closed: (a) the paper's search cell at the reference's
     dryrun_search settings on the main path's collection (a DSTree at
     leaf_cap 512, 256 noisy queries of seed 11, k = 100, nprobe 128,
     visit_batch 8; n_per_shard cut from 2,000,000 to N for host time),
     solo and with share_gathers, each through
     ``dryrun_search.lower_search`` measured by
     ``roofline.profile_device`` (CUDA events over 3 steps after a warm
     one, one profiled step: busy time, idle share, kernels, roofline
     share against the analytic terms), every returned distance its
     id's true distance, recall against brute force reported, the path's
     kernel inputs held against the plain versions; (b) every production
     cell (ARCH_IDS x SHAPES) that the dry run (``dryrun.fits_hbm`` on
     meta, at world 1) says fits one card, which must include gemma2-2b
     long_500k (run first) and mamba2-370m decode_32k and long_500k: the
     cell's ``lower_cell`` report, then bf16 weights drawn on the card
     from seed 23, the cache at the shape's capacity, one decode step at
     pos = seq - 1 warm, 3 timed and one profiled, the logits finite;
     the meta run's live bytes beside max_memory_allocated and
     chip_smoke's own decode bound beside the analytic terms. Launch
     counts are zeroed before and read after; K1, K4 and lex_select must
     have run;
  16. the engine across ranks (core/engine.py's mesh mode, launch/mesh.py):
     a world of one rank over NCCL on the card and a (1, 1) ("data",
     "model") mesh; the main path's collection as a mesh engine (DSTree
     at leaf_cap 256, an f32 spill) and as the one-card engine with
     shards=1 from the same collection and seed. Rows exact, eps=1,
     d=.99,eps=1, ng(4), ng(4)+share and exact+sync_bsf on both: ids,
     distances, visit counts, lb_computed and iterations bit-equal, exact
     rows brute force's ids (ties aside) from the phase's own brute force
     (bit-equal to phase 5's); eps=1 out of core from the spill equal to
     its resident row; one profiled ng(4)+sync_bsf query counts the
     collectives (NCCL kernels on the card, c10d operations on the
     host). Launch counts are zeroed before and read after, with brute
     force and the one-card engine run uncounted beside the path; K1, K4
     and lex_select must have run (K3 is not on the mesh path); the
     mesh engine's kernel inputs are held against the plain versions.
     The process group is destroyed after;
  17. training across ranks (launch/sharding.py, models/sharding_utils.py,
     the train step on DTensors): a world of one rank over NCCL and a
     (1, 1) ("data", "model") mesh; gemma2-2b at full width and depth in
     bf16 (seed 24) through ``fit(mesh=)`` for 2 steps of 1 x 2048 tokens,
     every parameter and moment a DTensor laid out by the rules, then,
     with the mesh run's model and moments freed and its parameters kept
     on the host, the one-card ``fit`` from the same seed, with
     deterministic algorithms on for both: each step's loss and time, the
     largest difference of each parameter leaf (TRAIN_MESH_*; bit-equal
     expected at world 1) and the collectives of one more profiled mesh
     step; then ``compressed_psum`` over a full-width gradient leaf,
     bit-equal to the local quantize-dequantize at world 1. No kernel of
     the port lies on this path (launch counts all 0). The process group
     is destroyed after;
  18. the dry run at the production meshes (launch/dryrun.py,
     launch/dryrun_search.py over launch/mesh.init_dry_world), a host
     step in a subprocess of its own (a dry world cannot share a process
     with the NCCL worlds of phases 16 and 17), bounded at DRY_TIMEOUT
     seconds: ``lower_cell`` for gemma2-2b ``decode_32k`` at full width
     and depth on the 16 x 16 dry mesh (meta tensors, no allocation) and
     ``lower_search`` on the 2 x 16 x 16 one; each must give status ok
     and record collectives. No kernel lies on this path;
  19. kernels at the main path's shapes: each kernel against its plain
     version, timed with CUDA events beside the plain version, one
     PyTorch library call where one computes the same function (for K3
     the cuBLAS expanded form; cdist beside it as ``cdist_ms``), and the
     least time the card could take (bound_ms). ``launches`` counts the
     in-memory path for K1-K4 and lex_select, the out-of-core path for K5
     and K6; ``launches_by_path`` gives every path's. A line splits K4
     and K6 into their score and select passes, and K3 and lex_select at
     the HNSW build's block, lex_select at kk = 1200 and 4096 and K1 at
     D = 64 are timed too.

Each phase's wall seconds are printed on a line of their own (``phase N
name: S s``). Prints a ``{"serving": ...}`` line, an ``{"llm": ...}``
line, a ``{"families": ...}`` line, an ``{"encdec": ...}`` line, a
``{"train": ...}`` line, a ``{"roofline": ...}`` line, a ``{"mesh": ...}``
line, a ``{"train_mesh": ...}`` line, a ``{"dry_run": ...}`` line, a
``{"kernels": [...]}`` line, then
``{"ok": true, "device": ...}`` as its last line. Exits non-zero without a result when no CUDA device
is present or the package is missing.
"""

from __future__ import annotations

import os

# cuBLAS needs a fixed workspace for the bitwise replay of the training
# phase (torch.use_deterministic_algorithms); set before torch loads
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import argparse
import contextlib
import json
import shutil
import sys
import threading
import time
import warnings
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
# H100 SXM published peaks (NVIDIA data sheet), the port's one set: f32
# outside the tensor cores, bf16 on them, and device memory bandwidth;
# the profiler's busy time of one call, and the card's name and power
# limit as nvidia-smi prints them. The f32 rate counts an FMA as two
# operations, so an f32 instruction that is not an FMA issues at half it
from repro_torch.launch.roofline import (  # noqa: E402
    HBM_BW as PEAK_BYTES, PEAK_F32_FLOPS, PEAK_FLOPS as PEAK_BF16_FLOPS,
    card as card_name, device_busy)

PEAK_F32_INSTR = PEAK_F32_FLOPS / 2
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


def ties_only(torch, got_ids, want_ids, dist, what: str,
              distinct: bool = True) -> int:
    """Rows of ids [B, k] (-1 = none) against the reference's: where an id
    differs from the reference's at the same rank, the two are a tie.
    ``dist`` is a function of ids giving their true squared distances
    (float64, inf for -1), and the two ids' distances must lie within the
    distance tolerance; or it is the reference's sorted squared distances
    [B, k] (for distances that are not true distances, IMI's ADC), and
    the reference's distance at that rank must tie with a neighbouring
    rank's. Each row holds distinct ids unless ``distinct`` is false
    (QALSH merges a point again each step it is refined). Returns the
    number of such swaps."""
    got_ids = got_ids.to(want_ids.device)
    if distinct:
        s, _ = torch.sort(got_ids.long(), dim=1)
        if bool(((s[:, 1:] == s[:, :-1]) & (s[:, 1:] >= 0)).any()):
            raise AssertionError(f"{what}: an id is returned twice")
    diff = got_ids != want_ids
    if not bool(diff.any()):
        return 0
    if callable(dist):
        dg, dw = dist(got_ids), dist(want_ids)
        gap = torch.where(diff, (dg - dw).abs(), torch.zeros_like(dg))
        bad = gap > DIST_ATOL + DIST_RTOL * dw.abs()
    else:
        wd = dist.to(want_ids.device).double()
        near = (wd[:, 1:] == wd[:, :-1]) | ((wd[:, 1:] - wd[:, :-1]).abs()
                                            <= DIST_ATOL + DIST_RTOL
                                            * wd[:, 1:])
        tie = torch.zeros_like(wd, dtype=torch.bool)
        tie[:, 1:] |= near
        tie[:, :-1] |= near
        bad = diff & ~tie
    if bool(bad.any()):
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
    # wider than 32 dims: chunks of 32, bit-equal to the plain version
    for b, L, d in [(1, 3, 16), (5, 1000, 32), (130, 700, 8),
                    (100, 4097, 16), (100, 4097, 33), (7, 1000, 48),
                    (130, 700, 64), (5, 3001, 100)]:
        q, lo = rn(b, d), rn(L, d) - 1.0
        hi = lo + rn(L, d).abs()
        w = rn(d).abs() + 0.5
        got, want = ops.box_mindist(q, lo, hi, w), \
            ref.ref_box_mindist(q, lo, hi, w)
        close(torch, got, want, f"box_mindist {b}x{L}x{d}")
        if d > 32 and not torch.equal(got, want):
            raise AssertionError(f"box_mindist {b}x{L}x{d} is not bit-exact")
    for b, m, n, dt in [(1, 1, 32, torch.float32),
                        (4, 100, 256, torch.float32),
                        (130, 257, 100, torch.float32),
                        (8, 64, 1000, torch.float32),
                        (7, 300, 256, torch.bfloat16),
                        (5, 33, 24, torch.bfloat16),
                        # IMI's coarse quantizer, a k-means subspace
                        # (PQ codebook of 256), an HNSW build block
                        (100, 16, 128, torch.float32),
                        (4096, 256, 16, torch.float32),
                        (513, 5000, 256, torch.float32)]:
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
            (10, 5000, 16, 2000, torch.float32, "integer"),
            (100, 1 << 18, 256, 200, torch.float32, ""),
            (100, 1 << 18, 256, 200, torch.float32, "masked"),
            # the cooperative step's form: slots read through an index
            # into a larger source, every fifth run of 128 slots masked
            # whole (a copy of a leaf another lane pooled), at both lane
            # tiles (104 lanes a block at B <= 104, else 128)
            (100, 25_600, 256, 200, torch.float32, "index"),
            (257, 30_001, 256, 200, torch.float32, "index"),
            (256, 1 << 18, 256, 200, torch.float32, "index"),
            (9, 3000, 64, 40, torch.bfloat16, "index")]:
        index = None
        if kind == "integer":  # exact arithmetic, ties decided by id
            q = torch.randint(-2, 3, (b, n), generator=g, device="cuda")
            rows = torch.randint(-2, 3, (r, n), generator=g, device="cuda")
            q, rows = q.float(), rows.float()
        else:
            q, rows = rn(b, n), rn(r, n, dtype=dt)
        norms = ops.row_sq_norms(rows)
        if kind == "index":
            src = rn(2 * r, n, dtype=dt)
            index = torch.randint(0, 2 * r, (r,), generator=g, device="cuda")
            rows, norms = src[index], ops.row_sq_norms(src)[index]
        ids = torch.randperm(r, generator=g, device="cuda").to(torch.int32)
        ids[::7] = -1
        if kind == "masked":  # every slot comes back as (inf, -1)
            ids[:] = -1
        if kind == "index":
            ids[torch.arange(r, device="cuda") // 128 % 5 == 3] = -1
            got = ops.coop_score_select(q, src, norms, ids, kk, index=index)
            del src
        else:
            got = ops.coop_score_select(q, rows, norms, ids, kk)
        want = ref.ref_coop_score_select(q, rows, norms, ids, kk)
        what = f"coop_score_select {b}x{r}x{n} kk={kk} {dt} {kind}"
        if kind in ("integer", "masked"):
            if not (torch.equal(got[0], want[0])
                    and torch.equal(got[1], want[1])):
                raise AssertionError(f"{what}: not exact")
        else:
            select_close(torch, got, want, q, rows, ids, what)
        del q, rows, norms, ids, got, want, index
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
                              (50, 5000, 16, 1200, "negative"),
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
    # read from device memory above; kk > 1024 sorted as runs of 8192 in
    # shared memory merged through device memory (20000: three runs)
    for b, r, kk, kind in [(3, 50, 7, ""), (5, 3000, 1024, "integer"),
                           (100, 25600, 800, ""), (9, 5000, 100, "negative"),
                           (7, 1 << 18, 1024, "integer"),
                           (6, 70000, 1000, "masked"),
                           (5, 3000, 1025, "integer"),
                           (100, 25600, 1200, ""),
                           (9, 9000, 4096, "negative"),
                           (4, 40000, 20000, "integer"),
                           (3, 70000, 20000, ""),
                           (2, 30000, 30000, "masked")]:
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


def phase_small_wide(torch, S, G, isax, baselines, randomwalk, queries
                     ) -> None:
    """The repaired limits and the vector baselines at N = 4096, card
    against CPU: share_gathers at k = 600 (a selection of kk = 1200), an
    iSAX2+ of 48 segments (boxes of 48 dims), and each baseline's query
    on one index, built on the card and copied to the CPU."""
    from repro_torch.device import to_device

    graph, imi, qalsh, srs = baselines
    data = randomwalk.generate(seed=3, n_series=4096, series_len=256)
    q = queries.noisy_queries(data, 16)
    data_t = torch.as_tensor(data, device="cuda")
    q_t = torch.as_tensor(q, device="cuda")
    dist64 = sq_dist64(torch, q_t, data_t,
                       torch.arange(data.shape[0], device="cuda"))
    runs = {}
    for dev in ("cuda", "cpu"):
        idx = isax.build(data, leaf_cap=64, device=dev)
        runs[dev] = S.search(idx, q, 600, G.exact(), visit_batch=4,
                             share_gathers=True, device=dev)
    dist_close(torch, runs["cuda"].dists.cpu() ** 2, runs["cpu"].dists ** 2,
               "small share k=600 squared dists")
    ties_only(torch, runs["cuda"].ids, runs["cpu"].ids.cuda(), dist64,
              "small share k=600 card vs CPU")
    wide = randomwalk.generate(seed=4, n_series=4096, series_len=192)
    qw = queries.noisy_queries(wide, 16)
    dist64w = sq_dist64(torch, torch.as_tensor(qw, device="cuda"),
                        torch.as_tensor(wide, device="cuda"),
                        torch.arange(wide.shape[0], device="cuda"))
    for dev in ("cuda", "cpu"):
        idx = isax.build(wide, n_segments=48, leaf_cap=64, device=dev)
        runs[dev] = S.search(idx, qw, 10, G.exact(), device=dev)
    dist_close(torch, runs["cuda"].dists.cpu() ** 2, runs["cpu"].dists ** 2,
               "small isax 48 segments squared dists")
    ties_only(torch, runs["cuda"].ids, runs["cpu"].ids.cuda(), dist64w,
              "small isax 48 segments card vs CPU")

    k = 10
    cases = {
        "hnsw": (lambda d: graph.build(data, m_links=8, device=d),
                 lambda i, d: graph.query(i, q, k, efs=32, device=d)),
        "imi": (lambda d: imi.build(data, kc=8, m=16, kmeans_iters=5,
                                    device=d),
                lambda i, d: imi.query(i, q, k, G.ng(8), device=d)),
        "srs": (lambda d: srs.build(data, m=16, device=d),
                lambda i, d: srs.query(i, q, k, G.delta_epsilon(0.9, 0.0),
                                       device=d)),
        "qalsh": (lambda d: qalsh.build(data, device=d),
                  lambda i, d: qalsh.query(i, q, k, device=d)),
    }
    cards = {}
    for name, (make, ask) in cases.items():
        card = cards[name] = make("cuda")
        got, want = ask(card, "cuda"), ask(to_device(card, "cpu"), "cpu")
        what = f"small {name} card vs CPU"
        dist_close(torch, got.dists.cpu() ** 2, want.dists ** 2,
                   f"{what} squared dists")
        # IMI's are ADC distances; QALSH may return an id twice
        ties_only(torch, got.ids, want.ids.cuda(),
                  want.dists ** 2 if name in ("imi", "qalsh") else dist64,
                  what, distinct=name != "qalsh")
        # QALSH's windows start at the query's rank on each line, found
        # from a projection that the card's GEMM rounds otherwise than
        # the CPU's: a query that is a row of the collection may land a
        # rank apart and refine a row more or fewer (ids still agree)
        for f in ("rows_scanned", "leaves_visited"):
            if name != "qalsh" and not torch.equal(getattr(got, f).cpu(),
                                                   getattr(want, f)):
                raise AssertionError(f"{what}: {f} differ")
    # the graph built on the CPU links the same members, up to ties
    cpu_adj = graph.build(data, m_links=8, device="cpu").adj
    card_adj = cards["hnsw"].adj.cpu()
    diff = cpu_adj != card_adj
    if bool(diff.any()):
        x = torch.as_tensor(data).double()
        node = torch.arange(data.shape[0])[None, :, None].expand_as(diff)

        def link(adj):
            return ((x[node[diff]] - x[adj[diff].long()]) ** 2).sum(-1)

        if bool(((link(card_adj) - link(cpu_adj)).abs()
                 > DIST_ATOL + DIST_RTOL * link(cpu_adj)).any()):
            raise AssertionError("small hnsw: the card's graph links "
                                 "other members than the CPU's, not ties")
    print(f"  small baselines: hnsw adjacency {int(diff.sum())} entries "
          f"differ from the CPU build (ties)")


def lex_equal(torch, ref, got, d, ids, kk: int, what: str) -> None:
    """lex_select's answer ``got`` on d [B, R] bit-equal to the plain
    version, which runs on a few lanes at a time to bound its memory."""
    step = max(1, (1 << 27) // d.shape[1])
    for s in range(0, d.shape[0], step):
        want = ref.ref_lex_select(d[s:s + step], ids, kk)
        if not (torch.equal(got[0][s:s + step], want[0])
                and torch.equal(got[1][s:s + step], want[1])):
            raise AssertionError(f"{what}: not bit-exact")


class PathInputs:
    """Installed over ``ops`` (``with``), records the inputs that a path
    gives each kernel wrapper, keywords included (K4's row ``index``),
    the first call at each shape; ``check`` then holds each wrapper
    against its plain version on them. The wrappers count their launches
    as before, and the launches that ``check`` makes to compare do not
    count."""

    def __init__(self, torch, ops, ref, wrappers):
        self.torch, self.ops, self.ref = torch, ops, ref
        self.wrappers = wrappers
        self.seen, self.held = {}, set()

    def __enter__(self):
        for name, fn in self.wrappers.items():
            setattr(self.ops, name, self._recording(name, fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self.wrappers.items():
            setattr(self.ops, name, fn)

    def _recording(self, name, fn):
        def shape(a):
            return tuple(a.shape) if hasattr(a, "shape") else a

        def call(*args, **kw):
            key = ((name,) + tuple(shape(a) for a in args)
                   + tuple((k, shape(v)) for k, v in sorted(kw.items())))
            if key not in self.held:
                self.seen.setdefault(key, (args, kw))
            return fn(*args, **kw)

        return call

    def check(self, what: str, dist_atol: float = DIST_ATOL) -> list:
        """Holds every recorded input; returns the keys held. ``dist_atol``
        is K3's absolute tolerance (DIST_ATOL at the main path's norms)."""
        torch, ref = self.torch, self.ref
        saved = {name: fn.launches for name, fn in self.wrappers.items()}
        try:
            for key, (args, kw) in self.seen.items():
                name, where = key[0], f"{what} {key}"
                fn = self.wrappers[name]
                if kw and name != "coop_score_select":
                    raise AssertionError(f"{where}: no plain check for "
                                         f"the keywords {sorted(kw)}")
                if name == "l2":
                    close(torch, fn(*args), ref.ref_l2(*args), where,
                          dist_atol, DIST_RTOL)
                elif name == "box_mindist":
                    close(torch, fn(*args), ref.ref_box_mindist(*args), where)
                elif name == "paa":
                    if not torch.equal(fn(*args), ref.ref_paa(*args)):
                        raise AssertionError(f"{where}: not bit-exact")
                elif name == "coop_score_select":
                    # slot r is rows[index[r]] (rows[r] with no index)
                    q, rows, norms, ids, kk = args
                    index = kw.get("index")
                    slots = rows if index is None else rows[index]
                    select_close(torch, fn(*args, **kw),
                                 ref.ref_coop_score_select(q, slots, norms,
                                                           ids, kk),
                                 q, slots, ids, where)
                    del slots
                elif name == "pq_adc_select":
                    got, want = fn(*args), ref.ref_pq_adc_select(*args)
                    if not (torch.equal(got[0], want[0])
                            and torch.equal(got[1], want[1])):
                        raise AssertionError(f"{where}: not bit-exact")
                elif name == "pq_adc_batch":
                    if not torch.equal(fn(*args), ref.ref_pq_adc_batch(*args)):
                        raise AssertionError(f"{where}: not bit-exact")
                elif name == "lex_select":
                    lex_equal(torch, ref, fn(*args), *args, where)
                else:
                    raise AssertionError(f"{where}: no plain check for "
                                         f"{name} on this path")
                self.held.add(key)
        finally:
            for name, fn in self.wrappers.items():
                fn.launches = saved[name]
        keys, self.seen = list(self.seen), {}
        return keys


BASELINE_KNOBS = {
    "hnsw": [("efs8", dict(efs=8)), ("efs32", dict(efs=32)),
             ("efs128", dict(efs=128))],
    "imi": [("ng(1)", dict(nprobe=1)), ("ng(8)", dict(nprobe=8)),
            ("ng(32)", dict(nprobe=32)),
            ("ng(32)+refine", dict(nprobe=32, refine=True))],
    "srs": [("d=0.5", dict(delta=0.5)), ("d=0.9", dict(delta=0.9)),
            ("d=0.99", dict(delta=0.99))],
    "qalsh": [("defaults", {})],
}


def phase_baselines(torch, G, baselines, data, q, truth, k, path):
    """The paper's vector baselines on the main path's data and queries,
    with the settings of its in-memory figure (bench_query_memory.py):
    HNSW m_links = 8, IMI kc = 16, m = 16, 10 k-means iterations, SRS
    m = 16, QALSH at its defaults. ``path`` (PathInputs) records the
    kernels' inputs through each build and each method's queries and
    holds them against the plain versions after it. Returns (table rows,
    build seconds, the kernel inputs held)."""
    from repro_torch.core.metrics import workload_metrics

    graph, imi, qalsh, srs = baselines
    builds = {
        "hnsw": lambda: graph.build(data, m_links=8),
        "imi": lambda: imi.build(data, kc=16, m=16, kmeans_iters=10),
        "srs": lambda: srs.build(data, m=16),
        "qalsh": lambda: qalsh.build(data),
    }

    def ask(name, idx, kw):
        if name == "hnsw":
            return graph.query(idx, q, k, **kw)
        if name == "imi":
            return imi.query(idx, q, k, G.ng(kw["nprobe"]),
                             refine=kw.get("refine", False))
        if name == "srs":
            return srs.query(idx, q, k, G.delta_epsilon(kw["delta"], 0.0))
        return qalsh.query(idx, q, k)

    table, secs, held = [], {}, []
    n_series = data.shape[0]
    for name, make in builds.items():
        with path:
            t0 = time.perf_counter()
            idx = make()
            torch.cuda.synchronize()
            secs[name] = time.perf_counter() - t0
        print(f"  {name} built in {secs[name]:.1f} s")
        held += path.check(f"{name} build")
        for knob, kw in BASELINE_KNOBS[name]:
            with path:
                t0 = time.perf_counter()
                res = ask(name, idx, kw)
                torch.cuda.synchronize()
                sec = time.perf_counter() - t0
            what = f"{name} {knob}"
            found = torch.isfinite(res.dists[:, 0])
            # QALSH's windows are fixed in ranks (frontier x steps = 512
            # a line), so at this N a noisy query may collide with no
            # point on l of m lines, the reference's behaviour; a query
            # that is a row of the collection (noise level 0: every fifth
            # query) collides with it on every line and must find it
            must = torch.arange(q.shape[0], device=found.device) % 5 == 0 \
                if name == "qalsh" else torch.ones_like(found)
            if res.dists.shape != (q.shape[0], k) or not bool(
                    found[must].all()):
                raise AssertionError(f"{what}: wrong shape or no finite "
                                     "nearest neighbour")
            if name == "qalsh" and not torch.equal(
                    res.ids[must, 0], truth.ids[must, 0]):
                raise AssertionError(f"{what}: a query that is a row of "
                                     "the collection did not find it")
            m = workload_metrics(res.ids, res.dists, truth.ids, truth.dists)
            table.append(dict(
                method=name, knob=knob, map=m["map"],
                recall=m["avg_recall"], mre=m["mre"],
                pct_data=100 * float(res.rows_scanned.float().mean())
                / n_series,
                rows=int(res.rows_scanned.long().sum()),
                found=int(found.sum()),
                iterations=res.iterations, ms=sec * 1e3,
                build_s=secs[name]))
        held += path.check(f"{name} queries")
        del idx
    row = {(r["method"], r["knob"]): r for r in table}
    checks = [
        (row[("hnsw", "efs128")]["recall"] >= row[("hnsw", "efs8")]["recall"],
         "hnsw recall(efs 128) >= recall(efs 8)"),
        (row[("imi", "ng(32)")]["recall"] >= row[("imi", "ng(1)")]["recall"],
         "imi recall(ng 32) >= recall(ng 1)"),
        (row[("imi", "ng(32)+refine")]["map"] >= row[("imi", "ng(32)")]["map"],
         "imi MAP(refine) >= MAP(plain)"),
        (row[("imi", "ng(32)+refine")]["mre"]
         <= row[("imi", "ng(32)")]["mre"] + 1e-6,
         "imi MRE(refine) <= MRE(plain)"),
        (row[("srs", "d=0.5")]["rows"] <= row[("srs", "d=0.99")]["rows"],
         "srs rows scanned(delta 0.5) <= (delta 0.99)"),
    ]
    for ok, what in checks:
        if not ok:
            raise AssertionError(f"baselines: {what} fails")
    return table, secs, held


def print_baseline_table(rows) -> None:
    hdr = (f"{'method':6s} {'knob':14s} {'MAP':>6s} {'recall':>7s} "
           f"{'MRE':>7s} {'%data':>8s} {'found':>5s} {'iters':>6s} "
           f"{'ms':>9s} {'build s':>8s}")
    print(hdr)
    print("-" * len(hdr))
    for r in rows:
        print(f"{r['method']:6s} {r['knob']:14s} {r['map']:6.3f} "
              f"{r['recall']:7.3f} {r['mre']:7.4f} {r['pct_data']:7.3f}% "
              f"{r['found']:5d} {r['iterations']:6d} {r['ms']:9.1f} "
              f"{r['build_s']:8.1f}")


def kernel_rows(torch, ops, ref, build, data_t, q_t, idx, vaf, k, counts,
                pq_in):
    """Each kernel at the main path's shapes: its error against the plain
    version, then the kernel's, the plain version's and a library call's
    times, and the least time the card could take. Prints the split of
    K4 and K6 into their score and select passes."""
    from repro_torch.core import refine
    from repro_torch.kernels import topk

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

    # K3: brute force over the collection; the library call is cuBLAS's
    # expanded form of the same function (both norms, addmm with alpha
    # -2 onto the rows' norms, the queries' norms added, clamped at 0;
    # TF32 is off), and cdist's matmul form, which adds a square root, is
    # timed beside it
    b = q_t.shape[0]

    def expanded():
        xn = data_t.square().sum(1)
        qn = q_t.square().sum(1)
        return torch.addmm(xn[None, :], q_t, data_t.T, alpha=-2).add_(
            qn[:, None]).clamp_min_(0.0)

    want = ref.ref_l2(q_t, data_t)
    dist_close(torch, expanded(), want, "l2 library expanded form")
    add("l2", dist_close(torch, ops.l2(q_t, data_t), want, "l2 main"),
        lambda: ops.l2(q_t, data_t), lambda: ref.ref_l2(q_t, data_t),
        4 * (b * n + n_rows * n + b * n_rows),
        2 * b * n_rows * n + 2 * (b + n_rows) * n + 3 * b * n_rows,
        library=expanded, reps=5)
    del want
    rows[-1]["cdist_ms"] = cuda_ms(torch, lambda: torch.cdist(
        q_t, data_t, compute_mode="use_mm_for_euclid_dist"), 5)
    print(f"K3 library: expanded form {rows[-1]['library_ms']:.4f} ms, "
          f"cdist {rows[-1]['cdist_ms']:.4f} ms, K3 {rows[-1]['ms']:.4f} ms")

    # K4: one cooperative iteration on iSAX2+ in the step's own form
    # (core/refine.refine_step): every lane pools a leaf, every fifth
    # lane a copy of its neighbour's, which the pool masks whole (the
    # search cell masks ~22% of its slots so), and the pass reads the
    # slots through their index. The bound counts the kept slots
    r = b * idx.max_leaf
    kk = min(2 * k, r)
    g4 = torch.Generator(device="cuda").manual_seed(4)
    leaf = torch.randint(idx.offsets.shape[0] - 1, (b, 1), generator=g4,
                         device="cuda")
    leaf[4::5] = leaf[3:b - 1:5]
    ok = torch.ones_like(leaf, dtype=torch.bool)
    gi, valid = refine.candidate_layout(idx.offsets, leaf, ok, idx.max_leaf,
                                        idx.data.shape[0] - 1)
    valid = refine.coop_mask(leaf, ok, valid)
    flat = gi.reshape(-1)
    ids4 = torch.where(valid, idx.ids[gi], -1).reshape(-1)
    q4, norms4, kk4 = q_t, idx.row_norms[flat], kk
    rows4 = idx.data[flat]  # the plain version's pool
    kept4 = int((ids4 >= 0).sum())
    masked4 = int((~(ids4 >= 0).view(-1, 128).any(1)).sum()) \
        if r % 128 == 0 else -1
    add("coop_score_select",
        select_close(torch, ops.coop_score_select(
            q4, idx.data, norms4, ids4, kk4, index=flat),
            ref.ref_coop_score_select(q4, rows4, norms4, ids4, kk4), q4,
            rows4, ids4, "coop main"),
        lambda: ops.coop_score_select(q4, idx.data, norms4, ids4, kk4,
                                      index=flat),
        lambda: ref.ref_coop_score_select(q4, rows4, norms4, ids4, kk4),
        4 * (b * n + kept4 * n + 2 * r) + 8 * r + 8 * b * kk,
        2 * b * kept4 * n + 2 * b * n + 3 * b * r)
    print(f"K4 main: {r} slots, {kept4} kept, {masked4} of {r // 128} "
          "128-slot tiles masked whole")

    # lex_select at K4's shape: the scores of that iteration, selected
    s4 = ops.sq_l2(q4, rows4, norms4)
    got, want = ops.lex_select(s4, ids4, kk4), ref.ref_lex_select(s4, ids4,
                                                                 kk4)
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise AssertionError("lex_select main: not bit-exact")
    add("lex_select", 0.0, lambda: ops.lex_select(s4, ids4, kk4),
        lambda: ref.ref_lex_select(s4, ids4, kk4),
        4 * (b * r + r) + 8 * b * kk4, b * r, rate=PEAK_F32_INSTR)
    split = {"K4 score": cuda_ms(torch, lambda: topk.score_pass(
        q4, idx.data, norms4, ids4, flat), 10)}
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


def shape_rows(torch, ops, ref, data_t, q_t):
    """Kernels at shapes beside the main path's, timed beside their bound:
    K3 and lex_select at the HNSW build's level-0 block (512 lanes against
    2^20 members, kk = 8, unstaged; the baselines phase held the same
    inputs against the plain versions), then, each checked bit-equal
    against its plain version first, lex_select at kk = 1200 and 4096
    (the sort through device memory) and K1 at D = 64 (chunks of 32
    dims)."""
    out = []

    def add(name, shape, fn, n_bytes, n_ops, rate=PEAK_F32_INSTR):
        bnd, by = bound_ms(n_bytes, n_ops, rate)
        out.append(dict(name=name, shape=shape, ms=cuda_ms(torch, fn, 5),
                        bound_ms=bnd, bound_by=by))

    def add_exact(name, shape, got, want, fn, n_bytes, n_ops):
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"{name} {shape}: not bit-exact")
        add(name, shape, fn, n_bytes, n_ops)

    n_rows, n = data_t.shape
    blk = 512
    x = data_t[:blk]
    add("l2", f"B={blk} M={n_rows} n={n} (HNSW build block)",
        lambda: ops.l2(x, data_t),
        4 * (blk * n + n_rows * n + blk * n_rows),
        2 * blk * n_rows * n + 2 * (blk + n_rows) * n + 3 * blk * n_rows,
        rate=PEAK_F32_FLOPS)
    d = ops.l2(x, data_t)
    rows = torch.arange(blk, device="cuda")
    d[rows, rows] = float("inf")
    ids = torch.arange(n_rows, dtype=torch.int32, device="cuda")
    add("lex_select", f"B={blk} R={n_rows} kk=8 (HNSW build block)",
        lambda: ops.lex_select(d, ids, 8),
        4 * (blk * n_rows + n_rows) + 8 * blk * 8, blk * n_rows)
    del d
    b, r = q_t.shape[0], 25600
    s = ops.l2(q_t, data_t[:r])
    ids = torch.arange(r, dtype=torch.int32, device="cuda")
    for kk in (1200, 4096):
        add_exact("lex_select", f"B={b} R={r} kk={kk}",
                  ops.lex_select(s, ids, kk), ref.ref_lex_select(s, ids, kk),
                  lambda kk=kk: ops.lex_select(s, ids, kk),
                  4 * (b * r + r) + 8 * b * kk, b * r)
    g = torch.Generator(device="cuda").manual_seed(7)
    dims = 64
    qb = torch.randn(b, dims, generator=g, device="cuda")
    lo = torch.randn(n_rows, dims, generator=g, device="cuda") - 1.0
    hi = lo + torch.rand(n_rows, dims, generator=g, device="cuda")
    w = torch.rand(dims, generator=g, device="cuda") + 0.5
    a = (qb, lo, hi, w)
    add_exact("box_mindist", f"B={b} L={n_rows} D={dims}",
              (ops.box_mindist(*a),), (ref.ref_box_mindist(*a),),
              lambda: ops.box_mindist(*a),
              4 * (b * dims + 2 * n_rows * dims + dims + b * n_rows),
              7 * b * n_rows * dims)
    return out


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


ENGINE_SHARDS = 4


def print_engine_table(rows) -> None:
    hdr = (f"{'mode':10s} {'guarantee':14s} {'MAP':>6s} {'%data':>7s} "
           f"{'it max':>6s} {'it sum':>6s} {'ms':>9s} {'read MB':>9s} "
           f"{'hit':>5s} {'fo':>3s} {'degr':>5s} {'eff delta':>10s}")
    print(hdr)
    print("-" * len(hdr))
    for r in rows:
        print(f"{r['mode']:10s} {r['guarantee']:14s} {r['map']:6.3f} "
              f"{r['pct_data']:6.2f}% {r['iters_max']:6d} "
              f"{r['iters_sum']:6d} {r['ms']:9.1f} "
              f"{r['bytes_read'] / 1e6:9.1f} {r['hit_rate']:5.3f} "
              f"{r['failovers']:3d} {str(r['degraded']):>5s} "
              f"{r['effective_delta']:10.3g}")


def phase_engine(torch, S, G, ref, data, q, truth, k, dist64, pq_map,
                 root: Path, path):
    """The sharded engine on the card: the main path's data range-sharded
    into 4 DSTree shards (leaf_cap 256), kept resident and spilled as f32
    stores with 2 replicas under ``root``; resident rows, the spilled
    rows served through open_spill, fault rows (owner kill, shard lost
    past its replicas, slow owner past its deadline, every shard lost),
    then one pq spill, whose MAP must reach ``pq_map`` (the single-index
    pq store's at the same guarantee). ``path`` (PathInputs) records the
    kernels' inputs through each build and row and holds them against
    the plain versions after it. A row with no injected fault must see
    no retry, failover or lost shard. Returns (table rows, build seconds
    by spill, the kernel inputs held, the engines: the resident one, the
    pq spill's, and the f32 spill's directory); the caller closes the
    engines and deletes ``root``."""
    from repro_torch.core.engine import DistributedEngine
    from repro_torch.core.metrics import workload_metrics
    from repro_torch.core.spec import IndexSpec, StoreSpec
    from repro_torch.fault import FaultInjector
    from repro_torch.serve.fault import RetryPolicy, ShardLost

    n_series = data.shape[0]
    ispec = IndexSpec("dstree", leaf_cap=256)
    table, builds, got, held = [], {}, {}, []

    def run(mode, gname, eng, g, **kw):
        with path:
            t0 = time.perf_counter()
            res = eng.query(q, k, g, **kw)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
        held.extend(path.check(f"engine {mode} {gname}"))
        m = workload_metrics(res.ids, res.dists, truth.ids, truth.dists)
        st = res.stats
        row = dict(mode=mode, guarantee=gname, map=m["map"],
                   pct_data=100 * float(res.rows_scanned.float().mean())
                   / n_series,
                   iters_max=max(res.iterations),
                   iters_sum=sum(res.iterations), ms=sec * 1e3,
                   bytes_read=st.bytes_read if st else 0,
                   hit_rate=st.hit_rate if st else 0.0,
                   failovers=st.failovers if st else 0,
                   degraded=st.degraded if st else False,
                   effective_delta=st.effective_delta if st else g.delta)
        table.append(row)
        print(f"  engine {mode} {gname}: {sec:.2f} s, iterations "
              f"{res.iterations}")
        if res.dists.shape != (q.shape[0], k) or not bool(
                torch.isfinite(res.dists[:, 0]).all()):
            raise AssertionError(f"engine {mode} {gname}: wrong shape or no "
                                 "finite nearest neighbour")
        if st is not None and "fault" not in kw.get("ooc_opts", {}) and (
                st.retries or st.failovers or st.shards_lost or st.degraded
                or 0 in res.iterations):
            raise AssertionError(
                f"engine {mode} {gname}: a shard failed with no fault "
                f"injected (retries {st.retries}, failovers {st.failovers}"
                f", lost {st.shards_lost}, iterations {res.iterations})")
        got[(mode, gname)] = res
        return res, row

    def exact_row(what, res, row):
        if f"{row['map']:.3f}" != "1.000":
            raise AssertionError(f"{what}: MAP {row['map']} on an exact row")
        swaps = ties_only(torch, res.ids, truth.ids, dist64, what)
        print(f"  {what}: ids are brute force's ({swaps} swaps of ties)")

    def same(what, a, b, fields=("ids", "dists", "leaves_visited",
                                 "rows_scanned"), tie_order=False):
        """Fields equal. With ``tie_order``, ids at bit-equal distances
        may come in another order: the resident merge keeps the shards'
        order among equal distances, the out-of-core fold orders them by
        id (as the reference's two merges do)."""
        for f in fields:
            x, y = getattr(a, f), getattr(b, f)
            if f == "ids" and tie_order and torch.equal(a.dists, b.dists):
                x = x.gather(1, ref.lex_order(a.dists, x))
                y = y.gather(1, ref.lex_order(b.dists, y))
            if not torch.equal(x, y):
                raise AssertionError(f"{what}: {f} differ")
        if tie_order:
            print(f"  {what}: equal ({int((a.ids != b.ids).sum())} ids "
                  "in another order among equal distances)")

    f32_dir = root / "f32"
    with path:
        t0 = time.perf_counter()
        eng = DistributedEngine(shards=ENGINE_SHARDS, method="dstree").build(
            data, index=ispec, store=StoreSpec(spill_dir=str(f32_dir),
                                               replicas=2))
        torch.cuda.synchronize()
        builds["resident+f32x2"] = time.perf_counter() - t0
    held.extend(path.check("engine build"))
    print(f"  engine built in {builds['resident+f32x2']:.1f} s: "
          f"{ENGINE_SHARDS} shards of "
          f"{[sh.num_leaves for sh in eng.resident]} leaves (padded), "
          f"f32 spill with 2 replicas under {f32_dir}")

    resident = {"exact": (G.exact(), {}), "eps=1": (G.epsilon(1.0), {}),
                "d=.99,eps=1": (G.delta_epsilon(0.99, 1.0), {}),
                "ng(nprobe=4)": (G.ng(4), {}),
                "exact+sync": (G.exact(), dict(sync_bsf=True)),
                "exact+share": (G.exact(), dict(share_gathers=True))}
    for gname, (g, kw) in resident.items():
        res, row = run("resident", gname, eng, g, **kw)
        if gname.startswith("exact"):
            exact_row(f"engine resident {gname}", res, row)
    plain, sync = got[("resident", "exact")], got[("resident", "exact+sync")]
    same("engine resident exact+sync vs exact", sync, plain,
         ("ids", "dists"))
    if not bool((sync.leaves_visited <= plain.leaves_visited).all()):
        raise AssertionError("engine exact+sync visits more leaves than "
                             "exact")
    print(f"  sync_bsf: {int(sync.leaves_visited.sum())} leaves visited "
          f"against {int(plain.leaves_visited.sum())}")
    resident_eng = eng

    spilled = DistributedEngine.open_spill(
        StoreSpec(spill_dir=str(f32_dir), keep_resident=False))
    try:
        for gname, g in (("exact", G.exact()), ("eps=1", G.epsilon(1.0)),
                         ("ng(nprobe=4)", G.ng(4))):
            res, row = run("spill f32", gname, spilled, g)
            same(f"engine spill f32 {gname} vs resident", res,
                 got[("resident", gname)], tie_order=True)
            if gname == "exact":
                exact_row("engine spill f32 exact", res, row)
        fast = dict(max_attempts=2, backoff_base_s=0.0)

        # the owner copy of shard 1 down: the replica answers in full
        inj = FaultInjector().kill_shard(1, replica=0)
        res, row = run("owner kill", "ng(nprobe=4)", spilled, G.ng(4),
                       ooc_opts=dict(fault=inj, retry=RetryPolicy(**fast)))
        same("engine owner kill", res, got[("spill f32", "ng(nprobe=4)")],
             ("ids", "dists"))
        if res.stats.failovers != 1 or res.stats.degraded:
            raise AssertionError(f"engine owner kill: failovers "
                                 f"{res.stats.failovers}, degraded "
                                 f"{res.stats.degraded}")

        # shard 2 down on every copy: the exact answer over the other
        # three quarters, with an honest delta
        inj = FaultInjector().kill_shard(2)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            res, row = run("shard lost", "exact", spilled, G.exact(),
                           ooc_opts=dict(fault=inj,
                                         retry=RetryPolicy(**fast)))
        if not any("lost past retries" in str(w.message) for w in caught):
            raise AssertionError("engine shard lost: no degradation warning")
        st = res.stats
        if not st.degraded or st.shards_lost != 1 \
                or not st.effective_delta < 1.0:
            raise AssertionError(f"engine shard lost: degraded {st.degraded}"
                                 f", lost {st.shards_lost}, effective_delta "
                                 f"{st.effective_delta}")
        bounds = np.linspace(0, n_series, ENGINE_SHARDS + 1).astype(np.int64)
        keep = np.ones(n_series, bool)
        keep[bounds[2]:bounds[3]] = False
        alive = torch.as_tensor(np.flatnonzero(keep),
                                device=truth.ids.device)
        with path:
            bf = S.brute_force(q, data[keep], k)
        held.extend(path.check("engine survivors' brute force"))
        what = "engine shard lost vs brute force over the survivors"
        dist_close(torch, res.dists, bf.dists, what)
        swaps = ties_only(torch, res.ids, alive[bf.ids.long()].to(
            torch.int32), dist64, what)
        print(f"  {what}: equal ({swaps} swaps of ties), effective_delta "
              f"{st.effective_delta:.6g}")

        # the owner of shard 0 stalls past its deadline: failover
        deadline = 2.0
        inj = FaultInjector().delay("gather", shard=0, replica=0,
                                    seconds=deadline + 0.5, times=1)
        res, row = run("slow owner", "ng(nprobe=4)", spilled, G.ng(4),
                       ooc_opts=dict(fault=inj, retry=RetryPolicy(
                           attempt_deadline_s=deadline, **fast)))
        same("engine slow owner", res, got[("spill f32", "ng(nprobe=4)")],
             ("ids", "dists"))
        if res.stats.failovers != 1:
            raise AssertionError(f"engine slow owner: failovers "
                                 f"{res.stats.failovers}")

        inj = FaultInjector()
        for si in range(ENGINE_SHARDS):
            inj.kill_shard(si)
        try:
            spilled.query(q, k, G.exact(), ooc_opts=dict(
                fault=inj, retry=RetryPolicy(**fast)))
        except ShardLost as e:
            print(f"  engine every shard lost: ShardLost ({e})")
        else:
            raise AssertionError("engine every shard lost: no ShardLost")
    finally:
        spilled.close()

    pq_dir = root / "pq"
    with path:
        t0 = time.perf_counter()
        eng = DistributedEngine(shards=ENGINE_SHARDS, method="dstree").build(
            data, index=ispec, store=StoreSpec(spill_dir=str(pq_dir),
                                               codec="pq",
                                               keep_resident=False))
        torch.cuda.synchronize()
        builds["pq"] = time.perf_counter() - t0
    held.extend(path.check("engine pq build"))
    print(f"  engine pq spill built in {builds['pq']:.1f} s")
    try:
        g = G.epsilon(1.0)
        res, row = run("spill pq", "eps=1+share", eng, g, share_gathers=True)
        ok = res.dists <= (1 + g.epsilon) * truth.dists * (1 + 1e-4) + 1e-4
        if not bool(ok.all()):
            raise AssertionError(f"engine spill pq: the epsilon bound holds "
                                 f"for {float(ok.float().mean()):.3f} of the "
                                 "ranks")
        if row["map"] < pq_map:
            raise AssertionError(f"engine spill pq: MAP {row['map']:.4f} "
                                 f"below the single pq store's {pq_map:.4f}")
        print(f"  engine spill pq: MAP {row['map']:.4f} against the single "
              f"pq store's {pq_map:.4f}")
    except BaseException:  # re-raised: release the engine on the way out
        eng.close()
        raise
    return table, builds, held, dict(resident=resident_eng, pq=eng,
                                     f32_dir=f32_dir)


INGEST_BATCH = 8192


def print_ingest_table(rows) -> None:
    hdr = (f"{'mode':10s} {'guarantee':18s} {'MAP':>6s} {'%data':>7s} "
           f"{'it max':>6s} {'it sum':>6s} {'ms':>9s} {'no writes':>9s} "
           f"{'delta rows':>10s} {'segments':>8s} {'dead':>6s} "
           f"{'read MB':>9s}")
    print(hdr)
    print("-" * len(hdr))
    for r in rows:
        before = f"{r['ms_before']:9.1f}" if r["ms_before"] else f"{'-':>9s}"
        print(f"{r['mode']:10s} {r['guarantee']:18s} {r['map']:6.3f} "
              f"{r['pct_data']:6.2f}% {r['iters_max']:6d} "
              f"{r['iters_sum']:6d} {r['ms']:9.1f} {before} "
              f"{r['delta_rows']:10d} {r['segments']:8d} {r['dead']:6d} "
              f"{r['bytes_read'] / 1e6:9.1f}")


def phase_ingest(torch, S, G, ref, data, data_t, q, truth0, k, engines,
                 before, path):
    """Streaming ingest on the engine phase's engines: the resident one,
    the f32 spill (opened again, so that the fault rows' breaker state
    stays behind) and the pq spill. Each takes the same writes: 4 batches
    of INGEST_BATCH fresh random walks (seed 12), compacted after each of
    the first three (3 segments; the fourth stays in the memtable), 1024
    base ids inserted again with new rows (seed 13), and deletes of each
    query's 5 nearest base rows (``truth0``), every row of the resident
    leaf that holds query 0's nearest, 8192 random base ids, 512 ids of
    the first segment and 256 of the memtable. Rows then run on
    each engine and are held against brute force (K3) over the live
    rows: exact rows return its ids up to ties, epsilon rows meet their
    bound, every returned id is live at its live row's distance (so no
    deleted or superseded copy surfaces), the spilled eps=1 row equals the
    resident one, and a rebuild from scratch over the live rows answers
    the exact row with the same ids up to ties. A fresh row asked as a
    query finds itself; a daemon (auto_compact) publishes a segment within
    a bounded wait. ``before`` maps (mode, guarantee) to the row's ms
    without writes; ``path`` holds the kernels' inputs. Returns (table
    rows, timings, kernel inputs held, the live rows: brute force over
    them, ids, rows, positions by id, the re-inserted ids)."""
    from repro_torch.core.engine import DistributedEngine
    from repro_torch.core.metrics import workload_metrics
    from repro_torch.core.spec import IndexSpec, StoreSpec
    from repro_torch.data import randomwalk
    from repro_torch.obs import REGISTRY

    n_series = data.shape[0]
    nb = INGEST_BATCH
    dev = data_t.device
    q_t = torch.as_tensor(q, device=dev)
    held, table, times = [], [], dict(insert_s=0.0, delete_s=0.0,
                                      compact_s=[], inserted=0, deleted=0)
    fresh = randomwalk.generate(seed=12, n_series=4 * nb, series_len=256)
    batch_ids = [n_series + nb * b + np.arange(nb) for b in range(4)]
    rng = np.random.default_rng(12)
    top5 = np.unique(truth0.ids[:, :5].cpu().numpy())
    # a whole leaf dead: the resident leaf that holds query 0's nearest row
    near = int(truth0.ids[0, 0])
    bounds = np.linspace(0, n_series, ENGINE_SHARDS + 1).astype(np.int64)
    si = int(np.searchsorted(bounds, near, side="right")) - 1
    sh = engines["resident"].resident[si]
    sh_ids = sh.ids.cpu().numpy()
    off = sh.offsets.cpu().numpy()
    leaf = int(np.searchsorted(off, int(np.flatnonzero(sh_ids == near)[0]),
                               side="right")) - 1
    leaf_ids = sh_ids[off[leaf]:off[leaf + 1]]
    top5 = np.union1d(top5, leaf_ids[leaf_ids >= 0])
    print(f"  a whole leaf dead: leaf {leaf} of shard {si}, "
          f"{int((leaf_ids >= 0).sum())} rows, holding query 0's nearest row")
    others = np.setdiff1d(np.arange(n_series), top5)
    re_ids = np.sort(rng.choice(others, 1024, replace=False))
    re_rows = randomwalk.generate(seed=13, n_series=1024, series_len=256)
    deleted = np.unique(np.concatenate([
        top5, rng.choice(np.setdiff1d(others, re_ids), 8192, replace=False),
        rng.choice(batch_ids[0], 512, replace=False),
        rng.choice(batch_ids[3], 256, replace=False)]))
    f32_dir = engines["f32_dir"]
    # the build's IndexSpec, which segments are built with
    ispec = IndexSpec("dstree", leaf_cap=256)
    spill = DistributedEngine.open_spill(
        StoreSpec(spill_dir=str(f32_dir), keep_resident=False), index=ispec)
    writers = {"resident": engines["resident"], "spill f32": spill,
               "spill pq": engines["pq"]}
    dead_t = torch.as_tensor(deleted, device=dev)
    live = {}

    def run(mode, gname, eng, g, check=True, **kw):
        with path:
            t0 = time.perf_counter()
            res = eng.query(q, k, g, **kw)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
        held.extend(path.check(f"ingest {mode} {gname}"))
        print(f"  ingest {mode} {gname}: {sec:.2f} s, iterations "
              f"{res.iterations}")
        if not check:
            return res, sec
        what = f"ingest {mode} {gname}"
        truth, truth_ids, dist64 = live["truth"], live["ids"], live["dist"]
        if res.dists.shape != (q.shape[0], k) or bool((res.ids < 0).any()):
            raise AssertionError(f"{what}: wrong shape or a missing id")
        if bool(torch.isin(res.ids, dead_t).any()):
            raise AssertionError(f"{what}: a deleted id was returned")
        # every (id, distance) is the live row's: a superseded copy of a
        # re-inserted id would come back at its old row's distance
        dist_close(torch, res.dists ** 2, dist64(res.ids),
                   f"{what}: distances of the live rows")
        m = workload_metrics(res.ids, res.dists, truth_ids, truth.dists)
        if g.epsilon > 0:
            ok = res.dists <= (1 + g.epsilon) * truth.dists * (1 + 1e-4) \
                + 1e-4
            if not bool(ok.all()):
                raise AssertionError(f"{what}: the epsilon bound holds for "
                                     f"{float(ok.float().mean()):.3f} of "
                                     "the ranks")
        elif g.nprobe is None:
            if f"{m['map']:.3f}" != "1.000":
                raise AssertionError(f"{what}: MAP {m['map']} on an exact "
                                     "row")
            swaps = ties_only(torch, res.ids, truth_ids, dist64, what)
            print(f"  {what}: ids are brute force's over the live rows "
                  f"({swaps} swaps of ties)")
        snap = eng._delta.snapshot()
        table.append(dict(
            mode=mode, guarantee=gname, map=m["map"],
            pct_data=100 * float(res.rows_scanned.float().mean())
            / live["n"], iters_max=max(res.iterations),
            iters_sum=sum(res.iterations), ms=sec * 1e3,
            ms_before=before.get((mode, gname)), delta_rows=snap.live_rows,
            segments=len(snap.segments), dead=int(deleted.shape[0]),
            bytes_read=res.stats.bytes_read if res.stats else 0))
        return res, sec

    try:
        # the pq row without writes, which the engine phase did not run
        pq_g = G.delta_epsilon(0.99, 1.0)
        _, sec = run("spill pq", "d=.99,eps=1+share", writers["spill pq"],
                     pq_g, check=False, share_gathers=True)
        before[("spill pq", "d=.99,eps=1+share")] = sec * 1e3

        for name, eng in writers.items():
            with path:
                for b in range(4):
                    t0 = time.perf_counter()
                    got = eng.insert(fresh[b * nb:(b + 1) * nb])
                    times["insert_s"] += time.perf_counter() - t0
                    times["inserted"] += nb
                    if not np.array_equal(got, batch_ids[b]):
                        raise AssertionError(f"ingest {name}: batch {b} got "
                                             "other ids")
                    if b < 3:
                        t0 = time.perf_counter()
                        if not eng.compact():
                            raise AssertionError(f"ingest {name}: compact() "
                                                 "published nothing")
                        torch.cuda.synchronize()
                        times["compact_s"].append(time.perf_counter() - t0)
                # a fresh row asked as a query finds itself at once
                res = eng.query(fresh[3 * nb:3 * nb + 8], 1, G.ng(1))
                if not np.array_equal(res.ids[:, 0].cpu().numpy(),
                                      batch_ids[3][:8]):
                    raise AssertionError(f"ingest {name}: a fresh row did "
                                         "not find itself")
                t0 = time.perf_counter()
                eng.insert(re_rows, ids=re_ids)
                times["insert_s"] += time.perf_counter() - t0
                times["inserted"] += re_ids.shape[0]
                t0 = time.perf_counter()
                eng.delete(deleted)
                times["delete_s"] += time.perf_counter() - t0
                times["deleted"] += deleted.shape[0]
            held.extend(path.check(f"ingest {name} writes"))
        print(f"  writes on 3 engines: {times['inserted']} rows inserted in "
              f"{times['insert_s']:.3f} s, {times['deleted']} deleted in "
              f"{times['delete_s']:.3f} s, 9 compactions "
              f"{', '.join(f'{c:.2f}' for c in times['compact_s'])} s")

        eng = writers["resident"]
        t0 = time.perf_counter()
        snap = eng._delta.snapshot()
        times["snapshot_ms"] = (time.perf_counter() - t0) * 1e3
        ids_host = [sh.ids.cpu().numpy() for sh in eng.resident]
        t0 = time.perf_counter()
        masks = [torch.as_tensor(snap.dead_mask(ids, 0), device=dev)
                 for ids in ids_host]
        torch.cuda.synchronize()
        times["mask_ms"] = (time.perf_counter() - t0) * 1e3
        base_dead = sum(int(m.sum()) for m in masks)
        print(f"  snapshot {times['snapshot_ms']:.1f} ms ({snap.live_rows} "
              f"delta rows, {len(snap.kills)} kills); tombstone masks of "
              f"{ENGINE_SHARDS} shards {times['mask_ms']:.1f} ms "
              f"({base_dead} base rows dead)")

        # the live rows, by global id, and brute force over them
        base_live = np.setdiff1d(np.arange(n_series),
                                 np.concatenate([deleted, re_ids]))
        batch_all = np.concatenate(batch_ids)
        keep = ~np.isin(batch_all, deleted)
        live_ids = np.concatenate([base_live, re_ids, batch_all[keep]])
        live_rows = torch.cat([
            data_t[torch.as_tensor(base_live, device=dev)],
            torch.as_tensor(re_rows, device=dev),
            torch.as_tensor(fresh[keep], device=dev)])
        with path:
            truth = S.brute_force(q, live_rows, k)
        held.extend(path.check("ingest brute force over the live rows"))
        ids_t = torch.as_tensor(live_ids, device=dev)
        pos = torch.zeros(n_series + 4 * nb, dtype=torch.long, device=dev)
        pos[ids_t] = torch.arange(ids_t.shape[0], device=dev)
        live.update(truth=truth, ids=ids_t[truth.ids.long()].to(torch.int32),
                    dist=sq_dist64(torch, q_t, live_rows, pos),
                    n=int(ids_t.shape[0]), rows=live_rows, pos=pos,
                    re_ids=re_ids, all_ids=live_ids)
        print(f"  live rows: {live['n']} ({base_live.shape[0]} base, "
              f"{re_ids.shape[0]} re-inserted, {int(keep.sum())} inserted)")

        got = {}
        for gname, g, kw in (("exact", G.exact(), {}),
                             ("eps=1", G.epsilon(1.0), {}),
                             ("d=.99,eps=1", G.delta_epsilon(0.99, 1.0), {}),
                             ("ng(nprobe=4)", G.ng(4), {}),
                             ("exact+share", G.exact(),
                              dict(share_gathers=True))):
            got[("resident", gname)], _ = run("resident", gname,
                                              writers["resident"], g, **kw)
        for gname, g in (("eps=1", G.epsilon(1.0)),
                         ("ng(nprobe=4)", G.ng(4))):
            got[("spill f32", gname)], _ = run("spill f32", gname, spill, g)
        run("spill pq", "d=.99,eps=1+share", writers["spill pq"], pq_g,
            share_gathers=True)

        a, b = got[("spill f32", "eps=1")], got[("resident", "eps=1")]
        for f in ("dists", "leaves_visited", "rows_scanned"):
            if not torch.equal(getattr(a, f), getattr(b, f)):
                raise AssertionError(f"ingest spill f32 eps=1 vs resident: "
                                     f"{f} differ")
        ai = a.ids.gather(1, ref.lex_order(a.dists, a.ids))
        bi = b.ids.gather(1, ref.lex_order(b.dists, b.ids))
        if not torch.equal(ai, bi):
            raise AssertionError("ingest spill f32 eps=1 vs resident: ids "
                                 "differ")
        print(f"  ingest spill f32 eps=1 equals resident eps=1 "
              f"({int((a.ids != b.ids).sum())} ids in another order among "
              "equal distances)")

        # a rebuild from scratch over the live rows, asked the exact row
        with path:
            t0 = time.perf_counter()
            rebuilt = DistributedEngine(shards=ENGINE_SHARDS).build(
                live_rows.cpu().numpy(), index=ispec)
            res = rebuilt.query(q, k, G.exact())
            torch.cuda.synchronize()
            times["rebuild_s"] = time.perf_counter() - t0
        held.extend(path.check("ingest rebuild"))
        del rebuilt
        mine = got[("resident", "exact")]
        r_ids = ids_t[res.ids.long()].to(torch.int32)
        swaps = ties_only(torch, mine.ids, r_ids, live["dist"],
                          "ingest resident exact vs a rebuild")
        dist_close(torch, mine.dists ** 2, res.dists ** 2,
                   "ingest resident exact vs a rebuild")
        same = mine.ids == r_ids
        bit = int((mine.dists == res.dists)[same].sum())
        why = "" if bit == int(same.sum()) else (
            " (the rest: cuBLAS sums each product in an order set by its "
            "pool's width, and a row sits in pools of other widths in the "
            "two)")
        print(f"  ingest resident exact vs a rebuild over the live rows "
              f"({times['rebuild_s']:.1f} s): ids equal up to {swaps} swaps "
              f"of ties; {bit} of {int(same.sum())} distances at equal ids "
              f"bit-equal{why}")

        # the daemon: a spill opened with auto_compact publishes a segment
        auto = DistributedEngine.open_spill(StoreSpec(
            spill_dir=str(f32_dir), keep_resident=False,
            delta_max_rows=nb, auto_compact=True, compact_interval_s=0.05),
            index=ispec)
        errors = REGISTRY.counter("delta.compaction_errors")
        errors.mark()
        try:
            extra = randomwalk.generate(seed=12, n_series=nb, series_len=256,
                                        start=4 * nb)
            with path:
                t0 = time.perf_counter()
                new = auto.insert(extra)
                while not auto._delta.segments():
                    if time.perf_counter() - t0 > 120:
                        raise AssertionError("ingest daemon: no segment "
                                             "published within 120 s")
                    time.sleep(0.02)
                times["daemon_s"] = time.perf_counter() - t0
                res = auto.query(extra[:8], 1, G.ng(4))
            held.extend(path.check("ingest daemon"))
            if auto._delta.snapshot().live_rows != 0 or not np.array_equal(
                    res.ids[:, 0].cpu().numpy(), new[:8]):
                raise AssertionError("ingest daemon: the segment does not "
                                     "serve the inserted rows")
        finally:
            auto.close()
        if errors.since_mark:
            raise AssertionError(f"ingest daemon: {errors.since_mark} "
                                 "compaction errors")
        print(f"  ingest daemon: {nb} rows inserted, segment published "
              f"after {times['daemon_s']:.2f} s, rows found in it")
    finally:
        spill.close()
    return table, times, held, live


# the deadline mix every serving point cycles through, in units of F (the
# resident engine's exact time on 8 queries): none and 1.6 F map to the
# exact tier, 0.8 F to delta-epsilon (0.99, eps 1), 0.2 F to ng(26), before
# any queue wait spends the budget
SERVE_MIX = (None, 1.6, 0.8, 0.2)
SERVE_BATCH = 8
SERVE_TIMEOUT_S = 600.0
TIER_RANK = {"exact": 0, "epsilon": 0, "delta-epsilon": 1, "ng": 2}
# R0's calibration requests, all queued at once
SERVE_R0_REQUESTS = 16
# name: (engine, front, rate in R0 or None for back to back, requests,
# admission depth cap). The counts are an eighth of the first design's
# (128 a point, 64 to calibrate): at F = 3.4-3.6 s that one took 752 s
# on the H100 and a quarter of it 316 s (PERF.md section 6), most of
# the smoke's limit on a slow host
SERVE_POINTS = {
    "static-1x": ("resident", "static", 1.0, 16, None),
    "static-4x": ("resident", "static", 4.0, 16, None),
    "cont-1x": ("resident", "cont", 1.0, 16, 64),
    "cont-4x": ("resident", "cont", 4.0, 16, 64),
    "burst": ("resident", "cont", None, 96, 32),
    "spill": ("spill f32", "cont", 1.0, 8, 64),
    "share": ("resident share", "cont", 1.0, 8, 64),
    "pq-share": ("spill pq share", "cont", 1.0, 8, 64),
}
# the write point: every WRITE_EVERY requests one insert of WRITE_ROWS
# fresh walks (probed once its ticket returns) and one delete of
# WRITE_DELS live base ids
WRITE_REQUESTS, WRITE_EVERY, WRITE_ROWS, WRITE_DELS = 16, 2, 256, 64
# concurrent = serial: 6 plans of CONC_QUERIES queries each, serially,
# then from 6 threads once
CONC_QUERIES = 2


class ShareGathers:
    """The smoke's thin wrapper over an engine: every query with
    share_gathers=True (the fronts pass only queries, k and g)."""

    def __init__(self, engine):
        self.engine = engine

    def query(self, q, k, g):
        return self.engine.query(q, k, g, share_gathers=True)


def print_serving_table(rows) -> None:
    hdr = (f"{'point':10s} {'engine':15s} {'offered':>7s} {'answered':>8s} "
           f"{'rejected':>8s} {'shed':>5s} {'rps':>7s} {'p50 ms':>9s} "
           f"{'(numpy)':>9s} {'p99 ms':>9s} {'(numpy)':>9s} "
           f"{'degraded':>8s}")
    print(hdr)
    print("-" * len(hdr))
    for r in rows:
        print(f"{r['point']:10s} {r['engine']:15s} {r['offered']:7d} "
              f"{r['answered']:8d} {r['rejected']:8d} {r['shed']:5d} "
              f"{r['rps']:7.2f} {r['p50']:9.1f} {r['np_p50']:9.1f} "
              f"{r['p99']:9.1f} {r['np_p99']:9.1f} {r['degraded']:8.3f}")


def phase_serving(torch, S, G, data_t, q, truth0, k, engines, live, path):
    """The serving front on the ingest phase's engines: the resident one
    with its write tier, the f32 spill opened again (no write tier: its
    live rows are the base rows) and the pq spill. Calibrates F (median
    ms of 5 serial exact queries of 8) and R0 (the static front's rate on
    SERVE_R0_REQUESTS requests of the mix, all queued at once), then drives the
    SERVE_POINTS open loop and the write point last. Every offered
    request is answered once or rejected with queue_full; admission's
    depth and the queue-depth gauge end at 0; exact answers return brute
    force's ids over the engine's live rows (ties allowed) at its
    distances; the burst rejects and sheds one tier; on the write point,
    each probe finds its inserted row first and no answer holds an id
    deleted before its request's submit. Then concurrent equals serial
    on the resident engine and the spill, and one traced spill group's
    span tree against its OocStats. ``path`` holds the kernels' inputs.
    Returns (table rows, a dict of the other numbers, kernel inputs
    held)."""
    from repro_torch import obs
    from repro_torch.clock import now
    from repro_torch.core.engine import DistributedEngine
    from repro_torch.core.spec import IndexSpec, StoreSpec
    from repro_torch.data import randomwalk
    from repro_torch.obs import REGISTRY, Histogram
    from repro_torch.serve import (AdmissionController, Rejected, Request,
                                   Scheduler, ServeFront,
                                   guarantee_for_deadline)

    dev = data_t.device
    q_t = torch.as_tensor(q, device=dev)
    n_series = data_t.shape[0]
    held, table, info = [], [], {}
    resident = engines["resident"]
    spill = DistributedEngine.open_spill(
        StoreSpec(spill_dir=str(engines["f32_dir"]), keep_resident=False),
        index=IndexSpec("dstree", leaf_cap=256))
    fronts = {"resident": resident, "spill f32": spill,
              "resident share": ShareGathers(resident),
              "spill pq share": ShareGathers(engines["pq"])}

    def request(i):
        """Request i of a point: query i (mod 100), deadline i of the mix
        in units of F."""
        m = SERVE_MIX[i % len(SERVE_MIX)]
        return Request(uid=i, prompt=np.zeros(4, np.int32),
                       deadline_ms=None if m is None else m * f_ms,
                       series=q[i % q.shape[0]])

    def paced(n, rate, submit_one):
        """Open loop: request i at start + i / rate, whatever the server
        does (None: back to back)."""
        start = now()
        for i in range(n):
            if rate:
                delay = start + i / rate - now()
                if delay > 0:
                    time.sleep(delay)
            submit_one(i)

    try:
        # ---- calibration on the resident engine
        ms = []
        for _ in range(5):
            t0 = time.perf_counter()
            res = resident.query(q[:8], k, G.exact())
            res.ids.cpu()
            ms.append((time.perf_counter() - t0) * 1e3)
        f_ms = float(np.median(ms))
        gkw = {"full_budget_ms": f_ms}
        mix = [guarantee_for_deadline(None if m is None else m * f_ms, **gkw)
               for m in SERVE_MIX]
        print(f"  F = {f_ms:.1f} ms (exact, 8 queries; runs "
              f"{', '.join(f'{x:.1f}' for x in ms)}); the mix maps to "
              + ", ".join(f"{g.kind}{'' if g.nprobe is None else g.nprobe}"
                          for g in mix))
        with path:
            sched = Scheduler(max_batch=SERVE_BATCH)
            for i in range(SERVE_R0_REQUESTS):
                sched.submit(request(i))
            t0 = now()
            while (nb := sched.next_batch()) is not None:
                sched.run_retrieval(resident, nb[1], k, **gkw)
            r0 = SERVE_R0_REQUESTS / (now() - t0)
        held.extend(path.check("serving calibration"))
        info.update(f_ms=f_ms, r0=r0)
        print(f"  R0 = {r0:.3f} requests/s (the static front on "
              f"{SERVE_R0_REQUESTS} requests of the mix, queued at once)")

        def serve_static(eng, n, rate, gkw):
            sched = Scheduler(max_batch=SERVE_BATCH)
            reqs, out, done_at, sizes, err = {}, {}, {}, [], []
            finished = threading.Event()

            def server():
                try:
                    while True:
                        last = finished.is_set()
                        nb = sched.next_batch()
                        if nb is None:
                            if last:
                                return
                            time.sleep(0.0005)
                            continue
                        got = sched.run_retrieval(eng, nb[1], k, **gkw)
                        t = now()
                        sizes.append(len(nb[1]))
                        for uid, entry in got.items():
                            if uid in out:
                                raise AssertionError(f"{uid} answered twice")
                            out[uid], done_at[uid] = entry, t
                except BaseException as e:  # re-raised on the main thread
                    err.append(e)

            srv = threading.Thread(target=server, name="static-server")
            srv.start()

            def submit_one(i):
                r = request(i)
                reqs[i] = r
                sched.submit(r)

            t0 = now()
            try:
                paced(n, rate, submit_one)
            finally:
                finished.set()
                srv.join(timeout=SERVE_TIMEOUT_S)
            wall = now() - t0
            if srv.is_alive() or err:
                raise AssertionError(f"static front: {err or 'hung'}")
            answers = {u: (reqs[u], dict(out[u], done_at=done_at[u]))
                       for u in out}
            return answers, {}, wall, {"static": (len(sizes),
                                                  float(np.mean(sizes)))}

        def serve_cont(eng, n, rate, depth, gkw, writes=None):
            adm = AdmissionController(max_depth=depth)
            front = ServeFront(eng, k, max_batch=SERVE_BATCH, admission=adm,
                               guarantee_kw=gkw).start()
            lanes = {m.labels: (m.count, m.sum) for m in
                     REGISTRY.collect("serve.lane.batch_size")}
            tickets, rejected = {}, {}

            def submit(r):
                try:
                    tickets[r.uid] = (r, front.submit(r))
                except Rejected as e:
                    rejected[r.uid] = e.reason

            def submit_one(i):
                submit(request(i))
                if writes is not None:
                    writes(i, front, submit)

            t0 = now()
            try:
                paced(n, rate, submit_one)
                answers = {u: (r, t.result(timeout=SERVE_TIMEOUT_S))
                           for u, (r, t) in tickets.items()}
            finally:
                front.stop(drain=True)
            wall = now() - t0
            if adm.depth or REGISTRY.gauge("serve.queue_depth").value:
                raise AssertionError(f"admission depth {adm.depth}, gauge "
                                     f"{REGISTRY.gauge('serve.queue_depth').value}"
                                     " after the point")
            sizes = {}
            for m in REGISTRY.collect("serve.lane.batch_size"):
                c0, s0 = lanes.get(m.labels, (0, 0.0))
                if m.count > c0:
                    sizes[dict(m.labels)["lane"]] = (m.count - c0,
                                                     (m.sum - s0)
                                                     / (m.count - c0))
            return answers, rejected, wall, sizes

        def check_exact(what, answers, truth_ids, truth_d, rows, pos):
            got = [(qi, e) for qi, e in answers if e["kind"] == "exact"]
            if not got:
                return 0
            qi = torch.as_tensor([g[0] for g in got], device=dev)
            ids = torch.as_tensor(np.stack([e["ids"] for _, e in got]),
                                  device=dev)
            d = torch.as_tensor(np.stack([e["dists"] for _, e in got]),
                                device=dev)
            dist_close(torch, d ** 2, truth_d[qi] ** 2, what)
            swaps = ties_only(torch, ids, truth_ids[qi],
                              sq_dist64(torch, q_t[qi], rows, pos), what)
            print(f"  {what}: {len(got)} exact answers are brute force's "
                  f"({swaps} swaps of ties)")
            return len(got)

        def check_eps(what, answers, truth_d, eps):
            got = [(qi, e) for qi, e in answers if e["kind"] == "epsilon"]
            for qi, e in got:
                want = truth_d[qi].cpu().numpy()
                if not (e["dists"] <= (1 + eps) * want * (1 + 1e-4)
                        + 1e-4).all():
                    raise AssertionError(f"{what}: an epsilon answer breaks "
                                         "its bound")
            print(f"  {what}: {len(got)} epsilon answers within (1 + {eps})")

        def run_point(name, eng_name, front, rate, n, depth, writes=None):
            for c in REGISTRY.collect("serve.admission."):
                c.mark()
            rate_rps = None if rate is None else rate * r0
            # the pq codec cannot honour exact (search_ooc warns): its top
            # tier is eps = 1, as the engine phase's pq rows
            pkw = dict(gkw, epsilon=1.0) if "pq" in eng_name else gkw
            with path:
                if front == "static":
                    answers, rejected, wall, sizes = serve_static(
                        fronts[eng_name], n, rate_rps, pkw)
                else:
                    answers, rejected, wall, sizes = serve_cont(
                        fronts[eng_name], n, rate_rps, depth, pkw, writes)
            held.extend(path.check(f"serving {name}"))
            offered = n + (0 if writes is None else writes.probes)
            errors = [u for u, (_, e) in answers.items() if "error" in e]
            if errors:
                raise AssertionError(f"serving {name}: error entries "
                                     f"{[answers[u][1]['error'] for u in errors[:3]]}")
            if len(answers) + len(rejected) != offered or set(answers) \
                    & set(rejected):
                raise AssertionError(f"serving {name}: {len(answers)} "
                                     f"answered + {len(rejected)} rejected "
                                     f"of {offered} offered")
            if any(r != "queue_full" for r in rejected.values()):
                raise AssertionError(f"serving {name}: reject reasons "
                                     f"{set(rejected.values())}")
            if front != "static":
                n_acc = sum(c.since_mark for c in REGISTRY.collect(
                    "serve.admission.accepted"))
                n_rej = REGISTRY.counter("serve.admission.rejected",
                                         reason="queue_full").since_mark
                if (n_acc, n_rej) != (len(answers), len(rejected)):
                    raise AssertionError(f"serving {name}: accepted {n_acc}"
                                         f", rejected {n_rej} counted")
            lat = [(e["done_at"] - r.submitted_at) * 1e3
                   for r, e in answers.values()]
            h = Histogram("smoke.serve.latency_ms", ())
            for v in lat:
                h.record(v)
            shed = [e for _, e in answers.values() if e.get("shed")]
            degraded = sum(
                TIER_RANK[e["kind"]] > TIER_RANK[guarantee_for_deadline(
                    r.deadline_ms, **pkw).kind]
                for r, e in answers.values())
            row = dict(point=name, engine=eng_name, offered=offered,
                       answered=len(answers), rejected=len(rejected),
                       shed=len(shed), rps=len(answers) / wall,
                       p50=h.quantile(0.5), p99=h.quantile(0.99),
                       np_p50=float(np.quantile(lat, 0.5, method="lower")),
                       np_p99=float(np.quantile(lat, 0.99, method="lower")),
                       degraded=degraded / max(len(answers), 1),
                       wall_s=wall, batches=sizes)
            table.append(row)
            kinds = {}
            for _, e in answers.values():
                kinds[e["kind"]] = kinds.get(e["kind"], 0) + 1
            print(f"  serving {name}: {len(answers)} answered, "
                  f"{len(rejected)} rejected, {len(shed)} shed in "
                  f"{wall:.1f} s; kinds {kinds}; batches by lane (count x "
                  "mean size) " + ", ".join(f"{ln} {c} x {m:.2f}" for ln, (
                      c, m) in sorted(sizes.items())))
            return answers, rejected, shed

        live_truth, live_ids = live["truth"], live["ids"]
        for name, (eng_name, front, rate, n, depth) in SERVE_POINTS.items():
            answers, rejected, shed = run_point(name, eng_name, front, rate,
                                                n, depth)
            pairs = [(r.uid % q.shape[0], e) for r, e in answers.values()]
            what = f"serving {name}"
            if eng_name == "spill f32":
                check_exact(what, pairs, truth0.ids, truth0.dists, data_t,
                            torch.arange(n_series, device=dev))
            elif eng_name == "spill pq share":
                check_eps(what, pairs, live_truth.dists, 1.0)
            else:
                check_exact(what, pairs, live_ids, live_truth.dists,
                            live["rows"], live["pos"])
            if name == "burst":
                if not rejected or not shed:
                    raise AssertionError(f"serving burst: {len(rejected)} "
                                         f"rejected, {len(shed)} shed")
                below = {"exact": "delta-epsilon",
                         "epsilon": "delta-epsilon",
                         "delta-epsilon": "ng", "ng": "ng"}
                for e in shed:
                    if e["kind"] != below[e["nominal_kind"]]:
                        raise AssertionError(
                            f"serving burst: a shed {e['nominal_kind']} "
                            f"answer reports {e['kind']}")
                print(f"  serving burst: every shed answer one tier below "
                      f"its drained tier (drained as "
                      f"{sorted({e['nominal_kind'] for e in shed})})")

        # ---- the write point, last: inserts, deletes and probes
        new_rows = randomwalk.generate(
            seed=13, n_series=WRITE_ROWS * WRITE_REQUESTS // WRITE_EVERY,
            series_len=q.shape[1], start=1024)
        cands = np.unique(live_ids.cpu().numpy())
        cands = cands[(cands < n_series) & ~np.isin(cands, live["re_ids"])]
        dels = np.random.default_rng(13).choice(
            cands, WRITE_DELS * WRITE_REQUESTS // WRITE_EVERY, replace=False)

        class Writes:
            probes = WRITE_REQUESTS // WRITE_EVERY

            def __init__(self):
                self.inserts, self.deletes, self.probe_of = [], [], {}

            def __call__(self, i, front, submit):
                if i % WRITE_EVERY:
                    return
                j = i // WRITE_EVERY
                rows = new_rows[j * WRITE_ROWS:(j + 1) * WRITE_ROWS]
                ins = front.submit_write("insert", rows=rows).result(
                    timeout=SERVE_TIMEOUT_S)
                if "error" in ins:
                    raise AssertionError(f"serving write: {ins['error']}")
                self.inserts.append(ins)
                uid = 10_000 + j
                self.probe_of[uid] = int(ins["ids"][0])
                submit(Request(uid=uid, prompt=np.zeros(4, np.int32),
                               series=rows[0]))
                self.deletes.append(front.submit_write(
                    "delete", ids=dels[j * WRITE_DELS:(j + 1) * WRITE_DELS]))

        writes = Writes()
        answers, _, _ = run_point("write", "resident", "cont", 1.0,
                                  WRITE_REQUESTS, WRITE_REQUESTS
                                  + Writes.probes, writes)
        deletes = [t.result(timeout=SERVE_TIMEOUT_S) for t in writes.deletes]
        fresh_ms, visible_ms = [], []
        for ins, (uid, gid) in zip(writes.inserts, writes.probe_of.items()):
            r, e = answers[uid]
            if int(e["ids"][0]) != gid or float(e["dists"][0]) ** 2 > 1e-3:
                raise AssertionError(
                    f"serving write: probe {uid} returned {int(e['ids'][0])}"
                    f" at {float(e['dists'][0])}, not row {gid}")
            fresh_ms.append(ins["latency_ms"])
            visible_ms.append((e["done_at"] - ins["applied_at"]) * 1e3)
        dead_hits = 0
        for r, e in answers.values():
            gone = [d["ids"] for d in deletes
                    if d["applied_at"] < r.submitted_at]
            if gone and np.isin(e["ids"], np.concatenate(gone)).any():
                dead_hits += 1
        if dead_hits:
            raise AssertionError(f"serving write: {dead_hits} answers hold "
                                 "an id deleted before their submit")
        n_after = sum(1 for r, _ in answers.values()
                      if any(d["applied_at"] < r.submitted_at
                             for d in deletes))
        info.update(fresh_ms=fresh_ms, visible_ms=visible_ms, writes=dict(
            ins_ids=np.concatenate([np.asarray(i["ids"])
                                    for i in writes.inserts]),
            ins_rows=new_rows[:len(writes.inserts) * WRITE_ROWS],
            del_ids=dels))
        probe_d = max(float(answers[u][1]["dists"][0])
                      for u in writes.probe_of)
        print(f"  serving write: {len(writes.inserts)} inserts of "
              f"{WRITE_ROWS} rows and {len(deletes)} deletes of {WRITE_DELS}"
              f" ids through the write lane; every probe found its row "
              f"first (distance at most {probe_d:.4g}); no "
              f"deleted id in the {n_after} answers submitted after a delete;"
              f" insert submit -> applied {np.median(fresh_ms):.2f} ms "
              f"median ({max(fresh_ms):.2f} max), applied -> probe answered "
              f"{np.median(visible_ms):.1f} ms median "
              f"({max(visible_ms):.1f} max)")

        # ---- concurrent equals serial, at full size
        plans = [(0, G.exact()), (8, G.epsilon(1.0)),
                 (16, G.delta_epsilon(0.99, 1.0)), (24, G.ng(8)),
                 (4, G.exact()), (12, G.ng(4))]
        w = CONC_QUERIES
        for name, eng in (("resident", resident), ("spill f32", spill)):
            t0 = time.perf_counter()
            out, err = [None] * len(plans), []

            def run(j, out=out, err=err, eng=eng):
                try:
                    i, g = plans[j]
                    out[j] = eng.query(q[i:i + w], k, g)
                except BaseException as e:  # re-raised below
                    err.append(e)

            with path:
                serial = [eng.query(q[i:i + w], k, g) for i, g in plans]
                ts = [threading.Thread(target=run, args=(j,))
                      for j in range(len(plans))]
                for t in ts:
                    t.start()
                for t in ts:
                    t.join(timeout=SERVE_TIMEOUT_S)
            if err or any(t.is_alive() for t in ts):
                raise AssertionError(f"serving concurrent {name}: "
                                     f"{err or 'hung'}")
            for j, (a, b) in enumerate(zip(out, serial)):
                if not (torch.equal(a.ids, b.ids)
                        and torch.equal(a.dists, b.dists)):
                    raise AssertionError(f"serving concurrent {name}: plan "
                                         f"{j} differs from its serial "
                                         "answer")
            held.extend(path.check(f"serving concurrent {name}"))
            sec = time.perf_counter() - t0
            print(f"  serving concurrent = serial on {name}: 6 plans of {w} "
                  f"queries, serially then from 6 threads, bit-equal "
                  f"({sec:.1f} s)")

        # ---- one traced spill group: the span tree against its OocStats
        obs.clear()
        obs.enable()
        try:
            front = ServeFront(spill, k, max_batch=SERVE_BATCH,
                               guarantee_kw=gkw)
            ts = [front.submit(Request(uid=i, prompt=np.zeros(4, np.int32),
                                       series=q[i])) for i in range(2)]
            with path:
                front.start()
                try:
                    outs = [t.result(timeout=SERVE_TIMEOUT_S) for t in ts]
                finally:
                    front.stop()
        finally:
            obs.disable()
        held.extend(path.check("serving traced"))
        prof = obs.last_profile("serve.retrieval_group")
        st = outs[0]["stats"]
        if prof is None or prof.attrs["requests"] != 2 or any(
                "error" in o for o in outs):
            raise AssertionError("serving traced: not one group of 2")
        by_id = {sp.id: sp for sp in prof.spans}
        parent_of = {"engine.query": "serve.retrieval_group",
                     "engine.shard": "engine.query",
                     "ooc.query": "engine.shard",
                     "ooc.filter": "ooc.query", "ooc.iteration": "ooc.query",
                     "ooc.finalize": "ooc.query",
                     # the loop's own spans (core/search.Refinement)
                     "search.advance": "ooc.iteration",
                     "search.settle": "ooc.iteration",
                     "search.gather": "search.advance",
                     "search.score": "search.advance",
                     "ooc.gather": "search.gather",
                     "ooc.score": "search.score"}
        names = {}
        for sp in prof.spans:
            names[sp.name] = names.get(sp.name, 0) + 1
            want = parent_of.get(sp.name)
            if want is not None and by_id[sp.parent].name != want:
                raise AssertionError(f"serving traced: {sp.name} under "
                                     f"{by_id[sp.parent].name}")
        if names.get("engine.shard") != ENGINE_SHARDS or names.get(
                "ooc.query") != ENGINE_SHARDS or not names.get(
                "ooc.iteration") or names["ooc.iteration"] != names.get(
                "ooc.gather") or names["ooc.gather"] != names.get(
                "ooc.score"):
            raise AssertionError(f"serving traced: spans {names}")
        if prof.total("bytes_read") != st.bytes_read:
            raise AssertionError(f"serving traced: bytes_read "
                                 f"{prof.total('bytes_read')} in the spans, "
                                 f"{st.bytes_read} in OocStats")
        trace = Path(__file__).resolve().parent / "build" / \
            "chip_smoke_serve_trace.json"
        obs.dump_chrome_trace(str(trace))
        evs = json.loads(trace.read_text())["traceEvents"]
        if not evs or any(e["ph"] != "X" or e["dur"] < 0 for e in evs):
            raise AssertionError("serving traced: a malformed Chrome event")
        iters = [sp for sp in prof.spans if sp.name == "ooc.iteration"]
        it_ids = {sp.id for sp in iters}
        split = {"ooc.iteration": sum(sp.duration_ms for sp in iters)}
        for sp in prof.spans:
            if sp.parent in it_ids:
                split[sp.name] = split.get(sp.name, 0.0) + sp.duration_ms
        n_it = len(iters)
        split = {name: ms / n_it for name, ms in split.items()}
        split["rest"] = split["ooc.iteration"] - sum(
            ms for name, ms in split.items() if name != "ooc.iteration")
        info["trace_split"] = split
        obs.clear()
        spill.query(q[:2], k, G.exact())
        if obs.tracer().spans():
            raise AssertionError("serving traced: spans with tracing off")
        print(f"  serving traced spill group (2 exact lanes, "
              f"{prof.duration_ms:.1f} ms): spans {names}; bytes_read "
              f"{st.bytes_read} in the spans and in OocStats; "
              f"{len(evs)} Chrome events in {trace}; no span with tracing "
              "off")
        print(f"  one spilled f32 iteration, mean of {n_it} by span (host "
              f"clock; the traced ooc.score waits for the device, ooc.gather "
              f"does not): " + ", ".join(f"{name} {ms:.3f} ms"
                                         for name, ms in split.items()))
        rms = {dict(m.labels)["kind"]: m.quantiles((0.5, 0.99))
               for m in REGISTRY.collect("serve.retrieval_ms")}
        info["retrieval_ms"] = rms
        print("  serve.retrieval_ms by kind: " + "; ".join(
            f"{kind} p50 {v['p50']:.1f} p99 {v['p99']:.1f}"
            for kind, v in sorted(rms.items())))
    finally:
        spill.close()
    return table, info, held


# the LLM substrate (phase 11): gemma2-2b at the full width and depth of
# src/repro_torch/configs/gemma2_2b.py, random weights from LLM_SEED
LLM_ARCH = "gemma2-2b"
# the reference's param_count and param_bytes of that config (bf16 weights,
# f32 norms)
LLM_PARAMS, LLM_BYTES = 2_614_341_888, 5_229_167_616
LLM_SEED = 20
# b: one block (local, then global) at full width, the card against the
# CPU on one set of weights: f32 (TF32 off) at atol = rtol = 1e-3; bf16 on
# the card against f32 on the CPU at LLM_BF16_VS_F32, about twice the
# largest error an H100 showed (1.16 on a decode logit; bf16's step near
# the final softcap's 30 is 0.125)
LLM_BLOCK_BATCH, LLM_BLOCK_LEN = 2, 64
LLM_F32_TOL = 1e-3
LLM_BF16_VS_F32 = dict(atol=2.0, rtol=0.02)
# c: an 8192-token prefill (blockwise; the local layers slide past their
# 4096 window) against the dense path forced on the same input, and 32
# decode steps from its cache against a full prefill, in bf16 at
# LLM_BF16_PATHS (on an H100 the two paths agreed bit for bit, decode and
# prefill within 1.06)
LLM_LONG, LLM_DECODE = 8192, 32
LLM_BF16_PATHS = dict(atol=2.0, rtol=0.02)
# d: timings
LLM_PREFILL_SHAPES = ((8, 512), (1, 8192))
LLM_DECODE_BATCHES = (1, 8, 32)
LLM_DECODE_CACHE = 2048
# e: retrieval-augmented serving over the serving phase's resident engine
# (SERVE_MIX's deadlines in units of its F, max batch SERVE_BATCH), then
# the flow of examples/retrieval_serving.py
RAG_REQUESTS, RAG_PROMPT, RAG_NEW, RAG_K = 16, (32, 1024), 32, 10
EXAMPLE_N, EXAMPLE_LEN, EXAMPLE_K, EXAMPLE_BATCH = 4096, 128, 5, 512
EXAMPLE_DEADLINES = (None, 40.0, 5.0, None, 2.0, 20.0, None, 1.0)


def llm_map(fn, tree, *more):
    """fn over the leaves of a tree of dicts (and of trees laid out alike)."""
    return {key: llm_map(fn, v, *(m[key] for m in more))
            if isinstance(v, dict) else fn(v, *(m[key] for m in more))
            for key, v in tree.items()}


def llm_events_ms(torch, fn, reps: int) -> float:
    """Mean milliseconds of fn() over reps calls by CUDA events, after one
    warm call: the host's launches are inside the window (an eager step is
    host-bound, and a user waits for it whole)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def llm_descs(cfg) -> list:
    """Every sub-layer of the stack in order, deepseek's dense first layer
    first."""
    from repro_torch.models.model import FIRST_LAYER

    return (([FIRST_LAYER] if cfg.dense_first_layer else [])
            + list(cfg.pattern) * cfg.num_blocks)


def llm_param_counts(cfg) -> dict:
    """The config's parameters, bytes, active parameters per token and the
    bytes of its expert stacks (the 'experts' axis), from its specs."""
    from repro_torch.models import model as M
    from repro_torch.models import params as P

    specs = M.model_specs(cfg)
    return dict(params=P.param_count(specs), bytes=P.param_bytes(specs),
                active=cfg.active_param_count(),
                expert_bytes=sum(s.size * s.dtype.itemsize
                                 for _, s in P.spec_leaves(specs)
                                 if "experts" in s.logical))


def llm_kv_bytes(cfg) -> int:
    """Bytes of KV cache per cached token over the attention sub-layers."""
    n_attn = sum(d.kind == "attn" for d in llm_descs(cfg))
    return (n_attn * 2 * cfg.num_kv_heads * cfg.head_dim
            * cfg.compute_dtype.itemsize)


def llm_ssm_bytes(cfg, b: int) -> int:
    """Bytes of the mamba sub-layers' decode state (conv tails and h) at
    batch b."""
    if cfg.ssm is None:
        return 0
    from repro_torch.models.ssm import ssm_cache_shape

    per = sum(int(np.prod(s)) for s in ssm_cache_shape(cfg.ssm, b).values())
    n_mamba = sum(d.kind == "mamba" for d in llm_descs(cfg))
    return n_mamba * per * cfg.compute_dtype.itemsize


def llm_ssd_ops(cfg, b: int, s: int) -> int:
    """f32 operations of the SSD products over every mamba sub-layer, as
    ssd_chunked forms them at its chunk: C·B and the weighted sum within
    each chunk, the chunk states and their contribution, the scan."""
    if cfg.ssm is None:
        return 0
    from repro_torch.models.ssm import _chunk_for

    c = _chunk_for(s, cfg.ssm.chunk)
    h, n, p = cfg.ssm.n_heads, cfg.ssm.d_state, cfg.ssm.head_dim
    per = 2 * b * (s // c) * h * (c * c * (n + p) + 2 * c * n * p + n * p)
    return per * sum(d.kind == "mamba" for d in llm_descs(cfg))


def llm_bound(n_bytes: float, bf16_ops: float, f32_ops: float) -> tuple:
    """(bound ms, what bounds it, operations): the bytes over the memory
    rate against the bf16 operations over the bf16 peak plus the f32 ones
    (the SSD scan, TF32 off) over the f32 peak."""
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = (bf16_ops / PEAK_BF16_FLOPS + f32_ops / PEAK_F32_FLOPS) * 1e3
    by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    return by + (bf16_ops + f32_ops,)


def llm_prefill_bound(cfg, counts: dict, b: int, s: int) -> tuple:
    """The least time of a prefill: every active parameter outside the
    embedding and head used once per token (2 operations each), the last
    position's logits, the attention as the chosen path computes it
    (scores and the weighted sum over every entry the path scores, masked
    ones too) and the SSD's products; against every parameter read once
    and the cache written once."""
    emb = cfg.vocab_size * cfg.d_model
    ops = 2 * (counts["active"] - emb * (1 if cfg.tie_embeddings else 2)
               ) * b * s
    ops += 2 * b * cfg.d_model * cfg.vocab_size
    blockwise = s > cfg.attn_dense_threshold and s % cfg.attn_chunk_q == 0
    for d in llm_descs(cfg):
        if d.kind != "attn":
            continue
        keys = s
        if (blockwise and d.attn_type == "local"
                and cfg.local_window + cfg.attn_chunk_q < s):
            keys = cfg.local_window + cfg.attn_chunk_q
        ops += 4 * b * cfg.num_heads * cfg.head_dim * s * keys
    n_bytes = (counts["bytes"] + llm_kv_bytes(cfg) * b * s
               + llm_ssm_bytes(cfg, b))
    return llm_bound(n_bytes, ops, llm_ssd_ops(cfg, b, s))


def llm_decode_bound(cfg, counts: dict, b: int, cap: int,
                     routed_bytes: int = 0) -> tuple:
    """The least time of a decode step: every parameter outside the experts
    read once (the tied logits read the whole table), the experts that the
    step's tokens route to (``routed_bytes``), the KV cache read at
    capacity, as the reference reads it, and the SSM state read and
    written; against 2 operations per active parameter used per token (an
    untied embedding is a lookup), the attention over the capacity and
    the state update and read-out per token."""
    n_bytes = (counts["bytes"] - counts["expert_bytes"] + routed_bytes
               + llm_kv_bytes(cfg) * b * cap + 2 * llm_ssm_bytes(cfg, b))
    lookup = 0 if cfg.tie_embeddings else cfg.vocab_size * cfg.d_model
    n_attn = sum(d.kind == "attn" for d in llm_descs(cfg))
    ops = 2 * (counts["active"] - lookup) * b + (
        4 * b * cfg.num_heads * cfg.head_dim * cap * n_attn)
    f32_ops = 0
    if cfg.ssm is not None:
        n_mamba = sum(d.kind == "mamba" for d in llm_descs(cfg))
        f32_ops = 4 * b * cfg.ssm.n_heads * cfg.ssm.d_state * (
            cfg.ssm.head_dim) * n_mamba
    return llm_bound(n_bytes, ops, f32_ops)


class Hooked:
    """``mod.name`` wrapped while inside ``with``: ``hook(args, result)``
    after every call."""

    def __init__(self, mod, name, hook):
        self.mod, self.name, self.hook = mod, name, hook

    def __enter__(self):
        self.orig = orig = getattr(self.mod, self.name)

        def call(*args, **kw):
            out = orig(*args, **kw)
            self.hook(args, out)
            return out

        setattr(self.mod, self.name, call)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.orig)


def llm_prefill_decode(torch, M, model, cfg, toks, dev, nxt=None,
                       routed=None, gaps=None):
    """Prefill of toks (capacity one more) and one decode step, on dev:
    (prefill logits, decode logits, the token fed), on the host; the token
    is the prefill's argmax unless ``nxt`` is given. The router's top-k
    ids of every MoE call are appended to ``routed``, and the smallest gap
    between each call's k-th and (k+1)-th probabilities to ``gaps``."""
    from repro_torch.models import moe

    def hook(args, res):
        if routed is not None:
            routed.append(res[1].cpu())
        if gaps is not None:
            k = cfg.moe.top_k
            srt = torch.softmax(args[0].float(), -1).sort(
                -1, descending=True).values
            gaps.append(float((srt[:, k - 1] - srt[:, k]).min()))

    n = toks.shape[1]
    with Hooked(moe, "_route", hook):
        lg, cache = M.prefill(model, {"tokens": toks.to(dev)}, cfg,
                              capacity=n + 1)
        if nxt is None:
            nxt = lg[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        dl, _ = M.decode_step(model, nxt.to(dev), cache, n, cfg)
    return lg.float().cpu(), dl.float().cpu(), nxt.cpu()


def llm_card_vs_cpu(torch, M, P, what, cfg1, toks, seed, bf16_tol):
    """An f32 (sub-)stack at full width drawn on the card from ``seed``:
    the prefill of toks and one decode step on the card (TF32 off) against
    the CPU at LLM_F32_TOL with the same routed ids, then in bf16 on the
    card against the f32 CPU at ``bf16_tol``. Returns (max abs errors,
    the smallest top-k router gap or None)."""
    import dataclasses

    tree = P.initialize(M.model_specs(cfg1), seed, "cuda")
    ids_c, ids_g, gaps = [], [], []
    lg_c, dl_c, nxt = llm_prefill_decode(
        torch, M, M.Model(cfg1, llm_map(lambda t: t.cpu(), tree)), cfg1, toks,
        "cpu", routed=ids_c, gaps=gaps)
    lg_g, dl_g, _ = llm_prefill_decode(torch, M, M.Model(cfg1, tree), cfg1,
                                       toks, "cuda", nxt, routed=ids_g)
    if len(ids_c) != len(ids_g) or not all(
            torch.equal(a, c) for a, c in zip(ids_c, ids_g)):
        raise AssertionError(f"{what}: the card routed other experts than "
                             "the CPU")
    errs = {"f32 prefill": close(torch, lg_g, lg_c, f"{what} f32 prefill",
                                 LLM_F32_TOL, LLM_F32_TOL),
            "f32 decode": close(torch, dl_g, dl_c, f"{what} f32 decode",
                                LLM_F32_TOL, LLM_F32_TOL)}
    cfg16 = dataclasses.replace(cfg1, param_dtype=torch.bfloat16,
                                compute_dtype=torch.bfloat16)
    tree16 = llm_map(lambda t, s: t.to(s.dtype), tree, M.model_specs(cfg16))
    del tree
    lg_h, dl_h, _ = llm_prefill_decode(torch, M, M.Model(cfg16, tree16),
                                       cfg16, toks, "cuda", nxt)
    del tree16
    errs["bf16 prefill"] = close(torch, lg_h, lg_c, f"{what} bf16 prefill",
                                 **bf16_tol)
    errs["bf16 decode"] = close(torch, dl_h, dl_c, f"{what} bf16 decode",
                                **bf16_tol)
    torch.cuda.empty_cache()
    return errs, (min(gaps) if gaps else None)


def llm_timings(torch, M, model, cfg, counts: dict, g) -> list:
    """Prefill (LLM_PREFILL_SHAPES) and decode (LLM_DECODE_BATCHES with an
    LLM_DECODE_CACHE-token cache) by CUDA events beside their bounds and
    one profiled call's device-busy time. A decode step's bound reads the
    experts its tokens route to, recorded in one untimed step."""
    from repro_torch.models import moe

    rows = []
    for b, s in LLM_PREFILL_SHAPES:
        t = torch.randint(0, cfg.vocab_size, (b, s), generator=g).cuda()

        def pre(t=t):
            return M.prefill(model, {"tokens": t}, cfg)

        ms = llm_events_ms(torch, pre, 3)
        busy, kernels = device_busy(pre)
        bound, by, ops = llm_prefill_bound(cfg, counts, b, s)
        rows.append(dict(what="prefill", batch=b, tokens=s, ms=ms,
                         tokens_per_s=b * s / ms * 1e3, bound_ms=bound,
                         bound_by=by, flops=ops, device_busy_ms=busy,
                         device_ops=kernels))
    per_expert = 0
    if cfg.moe is not None:
        per_expert = 3 * cfg.d_model * cfg.moe.d_ff_expert * (
            cfg.param_dtype.itemsize)
    for b in LLM_DECODE_BATCHES:
        cache = M.alloc_cache(cfg, b, LLM_DECODE_CACHE, "cuda")
        t = torch.randint(0, cfg.vocab_size, (b, 1), generator=g).cuda()

        def step(t=t, cache=cache):
            return M.decode_step(model, t, cache, LLM_DECODE_CACHE - 1, cfg)

        used = []
        with Hooked(moe, "_route", lambda a, r, used=used: used.append(
                int(r[1].unique().numel()))):
            step()
        ms = llm_events_ms(torch, step, 10)
        busy, kernels = device_busy(step)
        del cache, step  # 7 GB at batch 32 (gemma)
        bound, by, ops = llm_decode_bound(cfg, counts, b, LLM_DECODE_CACHE,
                                          sum(used) * per_expert)
        rows.append(dict(what="decode", batch=b, tokens=LLM_DECODE_CACHE,
                         ms=ms, tokens_per_s=b / ms * 1e3, bound_ms=bound,
                         bound_by=by, flops=ops, device_busy_ms=busy,
                         device_ops=kernels,
                         experts_read=sum(used) if used else None))
    return rows


def print_llm_timings(label: str, card: str, rows) -> None:
    print(f"  {label}: timings by CUDA events on {card} (prefill: batch x "
          f"tokens; decode: one step at batch B with a {LLM_DECODE_CACHE}-"
          "token cache):")
    for r in rows:
        print(f"    {r['what']:7s} {r['batch']:2d} x {r['tokens']:5d}: "
              f"{r['ms']:9.3f} ms, {r['tokens_per_s']:10.1f} tokens/s, "
              f"bound {r['bound_ms']:.3f} ms ({r['bound_by']}), "
              f"{r['bound_ms'] / r['ms']:.3f} of it; the device busy "
              f"{r['device_busy_ms']:.3f} ms of a profiled call "
              f"({r['device_ops']} kernels and copies)"
              + (f"; {r['experts_read']} experts read"
                 if r.get("experts_read") else ""))


def phase_llm_model(torch):
    """Parts a-d of the LLM phase: the full-width model, one full-width
    block on the card against the CPU, the long prefill's paths and decode
    consistency at full depth, and the timings. Returns (model, cfg, info)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models import params as P

    info = {}
    cfg = get_config(LLM_ARCH)
    counts = llm_param_counts(cfg)
    g = torch.Generator().manual_seed(LLM_SEED)

    # ---- a. the full-width model, bf16, on the card
    t0 = time.perf_counter()
    model = M.Model.init(cfg, LLM_SEED, "cuda")
    torch.cuda.synchronize()
    specs = M.model_specs(cfg)
    n_par, n_bytes = P.param_count(specs), P.param_bytes(specs)
    held = sum(p.numel() for p in model.parameters())
    held_bytes = sum(p.numel() * p.element_size()
                     for p in model.parameters())
    if (n_par, n_bytes, held, held_bytes) != (LLM_PARAMS, LLM_BYTES) * 2:
        raise AssertionError(f"llm: {n_par} parameters in {n_bytes} bytes "
                             f"({held} in {held_bytes} on the card), the "
                             f"reference counts {LLM_PARAMS} in {LLM_BYTES}")
    info.update(params=n_par, param_bytes=n_bytes,
                init_s=time.perf_counter() - t0)
    print(f"  llm a: {cfg.name} at full width ({cfg.num_layers} layers, "
          f"d_model {cfg.d_model}, {cfg.num_heads} q / {cfg.num_kv_heads} "
          f"kv heads of {cfg.head_dim}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}): {n_par} parameters, {n_bytes} bytes, the "
          f"reference's count; initialized on the card in "
          f"{info['init_s']:.1f} s")

    # ---- b. one block at full width: the card against the CPU
    cfg1 = dataclasses.replace(cfg, num_layers=cfg.period,
                               param_dtype=torch.float32,
                               compute_dtype=torch.float32)
    toks = torch.randint(0, cfg.vocab_size, (LLM_BLOCK_BATCH, LLM_BLOCK_LEN),
                         generator=g)
    tol = LLM_BF16_VS_F32
    errs, _ = llm_card_vs_cpu(torch, M, P, "llm b", cfg1, toks, LLM_SEED, tol)
    info["block_errors"] = errs
    print(f"  llm b: one block ({cfg1.num_layers} layers: "
          f"{', '.join(d.attn_type for d in cfg.pattern)}) at full width, "
          f"{LLM_BLOCK_BATCH} prompts of {LLM_BLOCK_LEN} tokens, prefill "
          f"and one decode step: the card (f32, TF32 off) equals the CPU "
          f"within atol = rtol = {LLM_F32_TOL}, bf16 on the card the f32 "
          f"CPU within atol {tol['atol']}, rtol {tol['rtol']}; max abs "
          "errors " + ", ".join(f"{key} {v:.3g}" for key, v in errs.items()))

    # ---- c. full depth, 8192 tokens: blockwise against dense, decode
    # against prefill past the window
    long = torch.randint(0, cfg.vocab_size, (1, LLM_LONG), generator=g
                         ).to("cuda")
    lg_b, cache = M.prefill(model, {"tokens": long}, cfg,
                            capacity=LLM_LONG + LLM_DECODE)
    dense = dataclasses.replace(cfg, attn_dense_threshold=LLM_LONG)
    lg_d, _ = M.prefill(model, {"tokens": long}, dense)
    tol = LLM_BF16_PATHS
    err_paths = close(torch, lg_b, lg_d, "llm c blockwise vs dense", **tol)
    steps, tok = [], lg_b[:, -1].argmax(-1, keepdim=True).to(torch.int32)
    fed = [tok]
    for t in range(LLM_DECODE):
        lg, cache = M.decode_step(model, tok, cache, LLM_LONG + t, cfg)
        steps.append(lg)
        tok = lg[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        fed.append(tok)
    del cache
    full = torch.cat([long] + fed[:-1], dim=1)  # 8192 + 32: the dense path
    x = M._backbone(model, full, cfg)[0]
    lg_full = M._logits(model, x[:, LLM_LONG:], cfg)
    del x
    lg_dec = torch.cat(steps, dim=1)
    err_dec = close(torch, lg_dec, lg_full, "llm c decode vs prefill", **tol)
    agree = float((lg_dec.argmax(-1) == lg_full.argmax(-1)).float().mean())
    for what, t in (("blockwise", lg_b), ("dense", lg_d), ("decode", lg_dec),
                    ("prefill", lg_full)):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"llm c: a non-finite {what} logit")
    info.update(paths_err=err_paths, decode_err=err_dec,
                decode_argmax_agree=agree)
    print(f"  llm c: {LLM_LONG}-token prefill at full depth, blockwise "
          f"(chunk {cfg.attn_chunk_q}; local layers slide a "
          f"{cfg.local_window + cfg.attn_chunk_q}-key window) against the "
          f"dense path forced: max abs error {err_paths:.3g}; {LLM_DECODE} "
          f"decode steps from its cache (window mask in force) against a "
          f"full {LLM_LONG + LLM_DECODE}-token prefill: max abs error "
          f"{err_dec:.3g}, argmax equal at {agree:.3f} of the steps; within "
          f"atol {tol['atol']}, rtol {tol['rtol']} (bf16); every logit "
          "finite")

    # ---- d. timings against their bounds
    info["card"] = card_name()
    info["timings"] = llm_timings(torch, M, model, cfg, counts, g)
    print_llm_timings("llm d", info["card"], info["timings"])
    return model, cfg, info


def llm_front_row(name, results, reqs, wall, check_ids):
    """Checks one front's results and returns its table row: every request
    answered once, or rejected with a reason; its tokens its
    max_new_tokens; each exact answer brute force's (check_ids)."""
    if sorted(results) != sorted(r.uid for r in reqs):
        raise AssertionError(f"{name}: answered {sorted(results)}")
    n_exact = 0
    for r in reqs:
        e = results[r.uid]
        if e["tokens"].shape != (r.max_new_tokens,):
            raise AssertionError(f"{name}: request {r.uid} has "
                                 f"{e['tokens'].shape} tokens")
        if "retrieval_error" in e or ("retrieval" in e) == (
                "retrieval_rejected" in e):
            raise AssertionError(f"{name}: request {r.uid} is neither "
                                 "answered nor rejected once")
        if e.get("retrieval", {}).get("kind") == "exact":
            check_ids(r, e["retrieval"])
            n_exact += 1
    lat = [e["latency_ms"] for e in results.values()]
    kinds = {}
    for e in results.values():
        kind = e.get("retrieval", {}).get("kind", "rejected")
        kinds[kind] = kinds.get(kind, 0) + 1
    return dict(front=name, requests=len(reqs), exact=n_exact,
                rejected=sum("retrieval_rejected" in e
                             for e in results.values()),
                p50=float(np.quantile(lat, 0.5, method="lower")),
                p99=float(np.quantile(lat, 0.99, method="lower")),
                generate_ms=float(np.median(
                    [e["generate_ms"] for e in results.values()])),
                retrieval_ms=float(np.median(
                    [e["retrieval_ms"] for e in results.values()])),
                rps=len(reqs) / wall, wall_s=wall, kinds=kinds)


def same_exact(name, a, b):
    """The static and continuous fronts' exact answers: the same tokens and
    the same ids."""
    n = 0
    for uid in a:
        ra, rb = a[uid].get("retrieval", {}), b[uid].get("retrieval", {})
        if ra.get("kind") == rb.get("kind") == "exact":
            if not (np.array_equal(a[uid]["tokens"], b[uid]["tokens"])
                    and np.array_equal(ra["ids"], rb["ids"])):
                raise AssertionError(f"{name}: request {uid} differs between "
                                     "the static and continuous fronts")
            n += 1
    return n


def llm_live_rows(torch, live, writes):
    """The serving phase's resident engine's live rows after its write
    point, on the card, and their global ids."""
    keep = ~np.isin(live["all_ids"], writes["del_ids"])
    rows = torch.cat([live["rows"][torch.as_tensor(keep, device="cuda")],
                      torch.as_tensor(writes["ins_rows"], device="cuda")])
    return rows, np.concatenate([live["all_ids"][keep], writes["ins_ids"]])


def llm_exact_checker(torch, S, path, held, what, series, rows, ids, k,
                      atol):
    """Brute force over rows (global ids ``ids``) for every request's
    series ({uid: series}), its kernel inputs held into ``held``; returns
    check(request, retrieval entry): an exact answer has brute force's
    ids, up to ties, at its distances."""
    dev = "cuda"
    ids_t = torch.as_tensor(ids, device=dev)
    pos = torch.zeros(int(ids_t.max()) + 1, dtype=torch.long, device=dev)
    pos[ids_t.long()] = torch.arange(ids_t.shape[0], device=dev)
    uids = list(series)
    qs = torch.as_tensor(np.stack([series[u] for u in uids]), device=dev)
    with path:
        truth = S.brute_force(qs, rows, k, device=dev)
    held.extend(path.check(f"{what} brute force", atol))
    t_ids = ids_t[truth.ids.long()].to(torch.int32)
    row_of = {u: i for i, u in enumerate(uids)}

    def check(r, ret):
        i, where = row_of[r.uid], f"{what} request {r.uid}"
        got = torch.as_tensor(ret["ids"], device=dev)[None]
        ties_only(torch, got, t_ids[i:i + 1],
                  sq_dist64(torch, qs[i:i + 1], rows, pos), where)
        close(torch, torch.as_tensor(ret["dists"], device=dev) ** 2,
              truth.dists[i] ** 2, where, atol, DIST_RTOL)

    return check


def phase_llm_serving(torch, S, model, cfg, resident, live, writes, q, f_ms,
                      root: Path, path):
    """Part e of the LLM phase: both fronts of launch/serve.py at full width
    over the serving phase's resident engine (its live rows after the write
    point), then the flow of examples/retrieval_serving.py. Returns (table
    rows, kernel inputs held)."""
    from repro_torch.core.engine import DistributedEngine
    from repro_torch.core.spec import IndexSpec, StoreSpec
    from repro_torch.data import randomwalk
    from repro_torch.launch.serve import (serve_requests,
                                          serve_requests_continuous)
    from repro_torch.models import model as M
    from repro_torch.serve import Request

    dev = "cuda"
    held, table = [], []
    rng = np.random.default_rng(LLM_SEED)

    def exact_checker(what, series, rows, ids, k, atol):
        return llm_exact_checker(torch, S, path, held, f"llm {what}", series,
                                 rows, ids, k, atol)

    def run_fronts(what, eng, reqs_of, gkw, k, max_batch, check, atol):
        outs = {}
        for front, fn in (("static", serve_requests),
                          ("continuous", serve_requests_continuous)):
            reqs = reqs_of()
            with path:
                t0 = time.perf_counter()
                outs[front] = fn(model, cfg, reqs, engine=eng, retrieval_k=k,
                                 max_batch=max_batch, guarantee_kw=gkw)
                wall = time.perf_counter() - t0
            held.extend(path.check(f"llm {what} {front}", atol))
            row = llm_front_row(f"llm {what} {front}", outs[front], reqs,
                                wall, check)
            row["flow"] = what
            table.append(row)
        n = same_exact(f"llm {what}", outs["static"], outs["continuous"])
        print(f"  llm {what}: {n} requests exact on both fronts, with the "
              "same tokens and ids on each")

    # ---- over the serving phase's resident engine
    rows, ids = llm_live_rows(torch, live, writes)
    lens = rng.integers(RAG_PROMPT[0], RAG_PROMPT[1] + 1, size=RAG_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in lens]
    series = {i: q[i % q.shape[0]] for i in range(RAG_REQUESTS)}

    mix = [SERVE_MIX[i % len(SERVE_MIX)] for i in range(RAG_REQUESTS)]

    def rag_requests():
        return [Request(uid=i, prompt=prompts[i], max_new_tokens=RAG_NEW,
                        deadline_ms=None if m is None else m * f_ms,
                        series=series[i]) for i, m in enumerate(mix)]

    check = exact_checker("rag", series, rows, ids, RAG_K, DIST_ATOL)
    run_fronts("rag", ShareGathers(resident), rag_requests,
               {"full_budget_ms": f_ms}, RAG_K, SERVE_BATCH, check, DIST_ATOL)

    # ---- the example's flow: embed walks by the mean final hidden state,
    # a bf16-spilled DSTree engine over the embeddings, 8 requests
    walks = randomwalk.generate(seed=7, n_series=EXAMPLE_N,
                                series_len=EXAMPLE_LEN)
    t0 = time.perf_counter()
    embs = []
    for i in range(0, EXAMPLE_N, EXAMPLE_BATCH):
        x = torch.as_tensor(walks[i:i + EXAMPLE_BATCH], device=dev)
        toks = ((x + 3) / 6 * (cfg.vocab_size - 1)).clamp(
            0, cfg.vocab_size - 1).to(torch.int32)
        embs.append(M._backbone(model, toks, cfg)[0].mean(dim=1).float())
    emb = torch.cat(embs).cpu().numpy()
    embed_s = time.perf_counter() - t0
    emb = ((emb - emb.mean(0)) / (emb.std(0) + 1e-9)).astype(np.float32)
    # squared distances in the expanded form cancel norms of about the
    # width here (z-scored dims), not 512: the f32 rounding DIST_ATOL
    # allows at the main path, scaled by the norms
    sq = (emb.astype(np.float64) ** 2).sum(1).max()
    atol = DIST_ATOL * max(1.0, 2 * sq / 512)
    if not np.isfinite(emb).all() or emb.shape != (EXAMPLE_N, cfg.d_model):
        raise AssertionError(f"llm example: embeddings {emb.shape}, finite "
                             f"{np.isfinite(emb).all()}")
    qi = rng.choice(EXAMPLE_N, len(EXAMPLE_DEADLINES), replace=False)
    ex_q = (emb[qi] + 0.05 * rng.normal(size=emb[qi].shape)).astype(
        np.float32)
    spill_dir = root / "llm_example"
    shutil.rmtree(spill_dir, ignore_errors=True)
    t0 = time.perf_counter()
    with path:
        eng = DistributedEngine(shards=1, device=dev).build(
            emb, index=IndexSpec("dstree", n_segments=8, leaf_cap=128),
            store=StoreSpec(spill_dir=str(spill_dir), codec="bf16",
                            keep_resident=False))
    held.extend(path.check("llm example build", atol))
    build_s = time.perf_counter() - t0
    try:
        # the store holds the bf16 image of the rows: brute force over it
        img = torch.as_tensor(emb, device=dev).to(torch.bfloat16).float()
        ex_prompts = [rng.integers(0, cfg.vocab_size,
                                   size=rng.integers(5, 12)).astype(np.int32)
                      for _ in EXAMPLE_DEADLINES]

        def ex_requests():
            return [Request(uid=i, prompt=ex_prompts[i], max_new_tokens=8,
                            deadline_ms=dl, series=ex_q[i])
                    for i, dl in enumerate(EXAMPLE_DEADLINES)]

        check = exact_checker("example", dict(enumerate(ex_q)), img,
                              np.arange(EXAMPLE_N), EXAMPLE_K, atol)
        run_fronts("example", eng, ex_requests, {}, EXAMPLE_K, 4, check,
                   atol)
    finally:
        eng.close()
        shutil.rmtree(spill_dir, ignore_errors=True)
    print(f"  llm example: {EXAMPLE_N} walks of {EXAMPLE_LEN} embedded by "
          f"the mean final hidden state ({cfg.d_model} dims) in "
          f"{embed_s:.1f} s; a bf16-spilled DSTree engine over them built "
          f"in {build_s:.1f} s; squared distances held at atol {atol:.3g} "
          f"(norms up to {sq:.0f})")
    return table, held


def print_llm_table(rows) -> None:
    hdr = (f"{'front':26s} {'requests':>8s} {'exact':>5s} {'rejected':>8s} "
           f"{'p50 ms':>9s} {'p99 ms':>9s} {'generate':>9s} {'retrieval':>9s} "
           f"{'rps':>6s}")
    print(hdr)
    print("-" * len(hdr))
    for r in rows:
        print(f"{r['front']:26s} {r['requests']:8d} {r['exact']:5d} "
              f"{r['rejected']:8d} {r['p50']:9.1f} {r['p99']:9.1f} "
              f"{r['generate_ms']:9.1f} {r['retrieval_ms']:9.1f} "
              f"{r['rps']:6.2f}")


# the families (phase 12): the MoE, SSM and hybrid decoders at full width
# in bf16, weights drawn on the card from FAM_SEED, one after another; each
# at the depth below with the reference's param_count and param_bytes at
# that depth (widths, experts, top-k, state sizes and vocabularies as
# published; jamba keeps 2 of its 4 8-layer blocks, dbrx 4 of its 40
# layers, where the whole would not fit in 80 GB)
FAM_SEED = 21
FAM = {
    "deepseek-moe-16b": (28, 16_375_728_128, 32_758_767_616),
    "mamba2-370m": (48, 368_227_840, 736_761_856),
    "jamba-v0.1-52b": (16, 25_998_322_688, 51_998_204_416),
    "dbrx-132b": (4, 14_269_470_720, 28_539_838_464),
}
# b: sub-stacks at full width, the card (f32, TF32 off) against the CPU at
# LLM_F32_TOL, and bf16 on the card against f32 on the CPU at
# FAM_BF16_VS_F32, gemma's (an H100 showed at most 0.039 on deepseek and
# jamba, and 1.78 on mamba2's tied logits of up to about 220);
# FAM_BLOCK prompts x tokens (two SSD chunks of 256)
FAM_BLOCK = (2, 512)
FAM_BF16_VS_F32 = dict(atol=2.0, rtol=0.02)
# c: a FAM_LONG prefill and FAM_DECODE steps against one full forward over
# both (dbrx: FAM_LONG_DBRX), at capacity factor 8.0 so that no copy is
# dropped (the reference's test_prefill_decode_consistency); the full
# forward's attention runs blockwise at FAM_FULL_CHUNK (which divides
# 8224) where the dense path's f32 score arrays would take more than
# FAM_SCORE_BYTES. bf16 stacks without SSM layers are held at FAM_PATHS,
# about twice the largest error an H100 showed (deepseek 1.66). With SSM
# layers, bf16 is reported, not held: 48 random mamba2 layers carry a
# rounding flip of one path far (mamba2's two prefill paths, chunk 256
# and chunk 32, differed by 18.5 on logits of up to 221 in bf16 and by
# 0.016 in f32); a model whose f32 copy takes at most FAM_F32_BYTES
# (mamba2) runs the check in f32 too, held at FAM_F32_PATHS (its largest
# error on an H100 0.014)
FAM_LONG, FAM_DECODE = 8192, 32
FAM_LONG_DBRX, FAM_DECODE_DBRX = 512, 8
FAM_PATHS = dict(atol=4.0, rtol=0.02)
FAM_F32_PATHS, FAM_F32_BYTES = dict(atol=0.05, rtol=1e-3), 4e9
FAM_FULL_CHUNK, FAM_SCORE_BYTES = 32, 16e9
# e: deepseek behind the static front over the serving phase's resident
# engine: one group of FAM_REQUESTS requests
FAM_REQUESTS = 8


def fam_sub_stacks(torch, cfg):
    """Part b's sub-stacks at full width, in f32: (name, config)."""
    import dataclasses

    from repro_torch.configs import LayerDesc

    f32 = dict(param_dtype=torch.float32, compute_dtype=torch.float32)
    if cfg.name == "deepseek-moe-16b":
        return [("first_layer + one MoE block",
                 dataclasses.replace(cfg, num_layers=2, **f32))]
    if cfg.name == "mamba2-370m":
        return [("one layer", dataclasses.replace(cfg, num_layers=1, **f32))]
    if cfg.name == "jamba-v0.1-52b":
        return [(f"{kind} + {ff}", dataclasses.replace(
            cfg, num_layers=1, pattern=(LayerDesc(kind, "global", ff),),
            **f32)) for kind, ff in (("mamba", "dense"), ("mamba", "moe"),
                                     ("attn", "dense"))]
    return []  # dbrx: deepseek covers the MoE arithmetic


def fam_card_vs_cpu(torch, M, P, cfg, g) -> dict:
    """Part b: llm_card_vs_cpu on each of the config's sub-stacks."""
    out = {}
    b, n = FAM_BLOCK
    toks = torch.randint(0, cfg.vocab_size, (b, n), generator=g)
    tol = FAM_BF16_VS_F32
    for name, cfg1 in fam_sub_stacks(torch, cfg):
        errs, gap = llm_card_vs_cpu(torch, M, P, f"{cfg.name} b {name}", cfg1,
                                    toks, FAM_SEED, tol)
        print(f"  {cfg.name} b: {name} at full width, {b} prompts of {n} "
              f"tokens, prefill and one decode step: the card (f32, TF32 "
              f"off) equals the CPU within atol = rtol = {LLM_F32_TOL}, bf16"
              f" on the card the f32 CPU within atol {tol['atol']}, rtol "
              f"{tol['rtol']}; max abs errors " + ", ".join(
                  f"{k} {v:.3g}" for k, v in errs.items())
              + ("" if gap is None else "; routed ids equal on both, "
                 f"smallest top-k gap {gap:.3g}"))
        out[name] = dict(errs, topk_gap=gap)
    return out


def fam_decode_check(torch, M, moe, ssm, model, cfg, g, tol) -> dict:
    """Part c: a long prefill, decode steps from its cache against one full
    forward over both, at capacity factor 8.0, held at ``tol`` (None:
    reported only); the dropped fraction at the published factor and the
    count of dt values the prefill clipped."""
    import dataclasses

    long_n, steps = ((FAM_LONG_DBRX, FAM_DECODE_DBRX)
                     if cfg.name == "dbrx-132b" else (FAM_LONG, FAM_DECODE))
    info = {}
    long = torch.randint(0, cfg.vocab_size, (1, long_n), generator=g
                         ).to("cuda")
    ccfg = cfg
    if cfg.moe is not None:
        drops = []
        with Hooked(moe, "moe_apply",
                    lambda a, r: drops.append(r[1]["moe_dropped_frac"])):
            M.prefill(model, {"tokens": long}, cfg)
        drops = torch.stack(drops).float().cpu()
        info.update(dropped_mean=float(drops.mean()),
                    dropped_max=float(drops.max()))
        ccfg = dataclasses.replace(
            cfg, moe=cfg.moe._replace(capacity_factor=8.0))
    clipped, seen = [0, 0], [0]

    def count_dt(args, _):
        params, dt, scfg = args[0], args[4], args[5]
        sp = torch.nn.functional.softplus(dt.float() + params["dt_bias"])
        clipped[0] += int((sp < scfg.dt_min).sum())
        clipped[1] += int((sp > scfg.dt_max * 100.0).sum())
        seen[0] += sp.numel()

    with Hooked(ssm, "_activate", count_dt):
        lg_p, cache = M.prefill(model, {"tokens": long}, ccfg,
                                capacity=long_n + steps)
    if cfg.ssm is not None:
        info.update(dt_below_min=clipped[0], dt_above_max=clipped[1],
                    dt_values=seen[0])
    dec, tok = [], lg_p[:, -1].argmax(-1, keepdim=True).to(torch.int32)
    fed = [tok]
    for t in range(steps):
        lg, cache = M.decode_step(model, tok, cache, long_n + t, ccfg)
        dec.append(lg)
        tok = lg[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        fed.append(tok)
    del cache
    full = torch.cat([long] + fed[:-1], dim=1)
    fcfg = ccfg
    n_full = full.shape[1]
    if (any(d.kind == "attn" for d in llm_descs(cfg)) and 3 * cfg.num_heads
            * n_full * n_full * 4 > FAM_SCORE_BYTES):
        fcfg = dataclasses.replace(ccfg, attn_chunk_q=FAM_FULL_CHUNK)
        info["full_chunk"] = FAM_FULL_CHUNK
    torch.cuda.empty_cache()  # jamba's full forward needs unfragmented room
    x = M._backbone(model, full, fcfg)[0]
    lg_full = M._logits(model, x[:, long_n:], fcfg)
    del x
    lg_dec = torch.cat(dec, dim=1)
    for what, t in (("prefill", lg_p), ("decode", lg_dec),
                    ("full", lg_full)):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{cfg.name} c: a non-finite {what} logit")
    err = float((lg_dec.float() - lg_full.float()).abs().max())
    agree = float((lg_dec.argmax(-1) == lg_full.argmax(-1)).float().mean())
    info.update(prefill=long_n, steps=steps, decode_err=err,
                decode_argmax_agree=agree)
    print(f"  {cfg.name} c: {long_n}-token prefill, {steps} decode steps "
          f"in {str(cfg.compute_dtype).rsplit('.', 1)[-1]} "
          f"from its cache against one full {n_full}-token forward"
          + (f" (attention blockwise at chunk {FAM_FULL_CHUNK})"
             if "full_chunk" in info else "")
          + f", capacity factor 8.0: max abs error {err:.3g}, argmax equal "
          f"at {agree:.3f} of the steps; every logit finite"
          + (f"; at the published {cfg.moe.capacity_factor} the prefill "
             f"dropped {info['dropped_mean']:.4f} of the copies (mean over "
             f"layers; max {info['dropped_max']:.4f})" if cfg.moe else "")
          + (f"; the prefill clipped {clipped[0]} of {seen[0]} dt values up"
             f" to dt_min and {clipped[1]} down to 100 dt_max"
             if cfg.ssm else "")
          + ("; reported, not held" if tol is None else
             f"; held at atol {tol['atol']}, rtol {tol['rtol']}"))
    if tol is not None:
        close(torch, lg_dec, lg_full, f"{cfg.name} c decode vs full", **tol)
    return info


def fam_serving(torch, S, model, cfg, resident, live, writes, q, f_ms,
                path) -> tuple:
    """Part e: one static group of FAM_REQUESTS requests behind
    launch/serve.py's static front over the serving phase's resident
    engine. Returns (table row, kernel inputs held)."""
    from repro_torch.launch.serve import serve_requests
    from repro_torch.serve import Request

    held = []
    rng = np.random.default_rng(FAM_SEED)
    rows, ids = llm_live_rows(torch, live, writes)
    lens = rng.integers(RAG_PROMPT[0], RAG_PROMPT[1] + 1, size=FAM_REQUESTS)
    series = {i: q[i % q.shape[0]] for i in range(FAM_REQUESTS)}
    mix = [SERVE_MIX[i % len(SERVE_MIX)] for i in range(FAM_REQUESTS)]
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, size=n
                                               ).astype(np.int32),
                    max_new_tokens=RAG_NEW,
                    deadline_ms=None if m is None else m * f_ms,
                    series=series[i])
            for i, (n, m) in enumerate(zip(lens, mix))]
    check = llm_exact_checker(torch, S, path, held, f"{cfg.name} e", series,
                              rows, ids, RAG_K, DIST_ATOL)
    with path:
        t0 = time.perf_counter()
        results = serve_requests(model, cfg, reqs,
                                 engine=ShareGathers(resident),
                                 retrieval_k=RAG_K, max_batch=FAM_REQUESTS,
                                 guarantee_kw={"full_budget_ms": f_ms})
        wall = time.perf_counter() - t0
    held.extend(path.check(f"{cfg.name} e static"))
    row = llm_front_row(f"{cfg.name} static", results, reqs, wall, check)
    row["flow"] = "families"
    return row, held


def phase_families(torch, S, resident, live, writes, q, f_ms, path):
    """The MoE, SSM and hybrid families at full width, one after another
    (parts a-d each; part e for deepseek). Returns (info, table rows,
    kernel inputs held)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models import moe, ssm
    from repro_torch.models import params as P

    info, table, held = {}, [], []
    info["allocated_gb_before"] = torch.cuda.memory_allocated() / 1e9
    for arch, (depth, want_par, want_bytes) in FAM.items():
        t_arch = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        cfg = dataclasses.replace(get_config(arch), num_layers=depth)
        g = torch.Generator().manual_seed(FAM_SEED)
        res = {"layers": depth}

        # ---- b first: the f32 sub-stacks must not sit beside the model
        res["card_vs_cpu"] = fam_card_vs_cpu(torch, M, P, cfg, g)

        # ---- a. the model at full width, bf16, on the card
        t0 = time.perf_counter()
        model = M.Model.init(cfg, FAM_SEED, "cuda")
        torch.cuda.synchronize()
        counts = llm_param_counts(cfg)
        held_par = sum(p.numel() for p in model.parameters())
        held_bytes = sum(p.numel() * p.element_size()
                         for p in model.parameters())
        if (counts["params"], counts["bytes"], held_par, held_bytes) != (
                want_par, want_bytes) * 2:
            raise AssertionError(
                f"{arch}: {counts['params']} parameters in "
                f"{counts['bytes']} bytes ({held_par} in {held_bytes} on "
                f"the card), the reference counts {want_par} in "
                f"{want_bytes} at {depth} layers")
        res.update(params=counts["params"], param_bytes=counts["bytes"],
                   active=counts["active"],
                   init_s=time.perf_counter() - t0,
                   mem_gb=torch.cuda.memory_allocated() / 1e9)
        print(f"  {arch} a: {depth} of {get_config(arch).num_layers} layers"
              f" at full width (d_model {cfg.d_model}, vocab "
              f"{cfg.vocab_size}): {counts['params']} parameters, "
              f"{counts['bytes']} bytes, the reference's count at this "
              f"depth; {counts['active']} active per token; initialized on "
              f"the card in {res['init_s']:.1f} s "
              f"({res['mem_gb']:.1f} GB allocated)")

        # ---- c. decode against the full forward, in bf16 and, where the
        # f32 copy fits beside it, in f32 (the same draws before the cast)
        res.update(fam_decode_check(torch, M, moe, ssm, model, cfg, g,
                                    None if cfg.ssm else FAM_PATHS))
        if 2 * counts["bytes"] <= FAM_F32_BYTES:
            cfg32 = dataclasses.replace(cfg, param_dtype=torch.float32,
                                        compute_dtype=torch.float32)
            m32 = M.Model.init(cfg32, FAM_SEED, "cuda")
            res["f32"] = fam_decode_check(
                torch, M, moe, ssm, m32, cfg32,
                torch.Generator().manual_seed(FAM_SEED), FAM_F32_PATHS)
            del m32

        # ---- d. timings
        card = card_name()
        res["card"] = card
        res["timings"] = llm_timings(torch, M, model, cfg, counts, g)
        print_llm_timings(f"{arch} d", card, res["timings"])

        # ---- e. retrieval-augmented serving, deepseek only
        if arch == "deepseek-moe-16b":
            row, h = fam_serving(torch, S, model, cfg, resident, live, writes,
                                 q, f_ms, path)
            table.append(row)
            held.extend(h)
            res["serving"] = row
        del model
        torch.cuda.empty_cache()
        res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        res["seconds"] = time.perf_counter() - t_arch
        print(f"  {arch}: {res['seconds']:.1f} s, peak {res['peak_gb']:.1f} "
              f"GB allocated")
        info[arch] = res
    return info, table, held


# ---------------------------------------------------------------------------
# 13. the encoder-decoder family
# ---------------------------------------------------------------------------

ENC_ARCH = "seamless-m4t-medium"
# the reference's param_count and param_bytes of that config (bf16 weights,
# f32 norms; final_norm counted, though the decoder ends in dec_norm)
ENC_PARAMS, ENC_BYTES = 716_452_864, 1_433_034_752
ENC_SEED = 22
# b: f32 (TF32 off) on the card against the CPU at ENC_F32_TOL: one encoder
# and one decoder layer over ENC_BLOCK prompts x decoder tokens and every
# frame, and encode + decode_train over ENC_CUT layers each
ENC_F32_TOL = 1e-4
ENC_BLOCK = (2, 64)
ENC_CUT = 2
# c: timings (decode: LLM_DECODE_BATCHES with an LLM_DECODE_CACHE cache)
ENC_PREFILL_SHAPES = ((8, 512), (1, 8192))
# d: generate(frames=) against one full forward, in bf16 at ENC_BF16_PATHS
# (1.6 x the largest error an H100 showed, 2.5: seamless has no final
# softcap to bound its logits, as gemma's are bound at 30) and on an f32
# copy of the same draws at ENC_F32_PATHS, the families' f32 tolerance
ENC_GEN_PROMPT, ENC_GEN_NEW = 512, 32
ENC_BF16_PATHS = dict(atol=4.0, rtol=0.02)
ENC_F32_PATHS = FAM_F32_PATHS


def enc_groups(cfg) -> dict:
    """Parameters and bytes of the encoder side (frontend, layers, norm),
    of the decoder layers (and of their cross k/v projections, which run
    over the frames), and of the rest (embedding, norms)."""
    from repro_torch.models import model as M
    from repro_torch.models import params as P

    out = dict(enc=0, enc_bytes=0, dec=0, dec_bytes=0, cross_kv=0,
               other=0, other_bytes=0)
    for path, s in P.spec_leaves(M.model_specs(cfg)):
        n, nb = s.size, s.size * s.dtype.itemsize
        if path.startswith(("encdec.encoder.", "encdec.frontend_proj",
                            "encdec.enc_norm")):
            out["enc"] += n
            out["enc_bytes"] += nb
        elif path.startswith("encdec.decoder."):
            out["dec"] += n
            out["dec_bytes"] += nb
            if ".cross_attn.wk" in path or ".cross_attn.wv" in path:
                out["cross_kv"] += n
        else:
            out["other"] += n
            out["other_bytes"] += nb
    return out


def enc_forward_ops(cfg, g: dict, b: int, s: int, f: int,
                    logit_rows: int) -> int:
    """Operations of encode over f frames and the decoder over s tokens:
    every encoder parameter once per frame, the cross k/v projections
    once per frame and the other decoder parameters once per token (2
    each), the attention as the paths score it (the encoder's F x F, the
    decoder's S x S causal path scored whole, the cross S x F), and the
    logits of ``logit_rows`` positions per prompt."""
    hd = cfg.num_heads * cfg.head_dim
    ops = 2 * g["enc"] * b * f + 4 * b * hd * f * f * cfg.encoder_layers
    ops += 2 * g["cross_kv"] * b * f + 2 * (g["dec"] - g["cross_kv"]) * b * s
    ops += 4 * b * hd * s * (s + f) * cfg.num_layers
    return ops + 2 * b * logit_rows * cfg.d_model * cfg.vocab_size


def enc_cache_bytes(cfg, b: int, s: int, f: int) -> int:
    return (2 * cfg.num_layers * b * (s + f) * cfg.num_kv_heads
            * cfg.head_dim * cfg.compute_dtype.itemsize)


def enc_prefill_bound(cfg, counts: dict, g: dict, b: int, s: int,
                      f: int) -> tuple:
    """Every parameter and the frames read once, the cache written once,
    against enc_forward_ops with the last position's logits."""
    n_bytes = (counts["bytes"] + b * f * cfg.d_model * 4
               + enc_cache_bytes(cfg, b, s, f))
    return llm_bound(n_bytes, enc_forward_ops(cfg, g, b, s, f, 1), 0)


def enc_decode_bound(cfg, g: dict, b: int, cap: int, f: int) -> tuple:
    """A decode step reads the decoder's parameters, the embedding (the
    tied logits), the self cache at capacity and the cross cache, and
    computes 2 operations per decoder parameter outside the cross k/v
    projections, the logits, and the attention over cap + f keys."""
    n_bytes = g["dec_bytes"] + g["other_bytes"] + enc_cache_bytes(
        cfg, b, cap, f)
    ops = (2 * (g["dec"] - g["cross_kv"]) * b
           + 2 * b * cfg.d_model * cfg.vocab_size
           + 4 * b * cfg.num_heads * cfg.head_dim * (cap + f)
           * cfg.num_layers)
    return llm_bound(n_bytes, ops, 0)


def enc_card_vs_cpu(torch, M, E, P, cfg, g) -> dict:
    """Part b: one encoder and one decoder layer at full width, and encode
    + decode_train over ENC_CUT layers each, f32 on the card (TF32 off)
    against the CPU on one set of weights; then bf16 on the card against
    the f32 CPU. Returns the max abs errors."""
    import dataclasses

    f32 = dict(param_dtype=torch.float32, compute_dtype=torch.float32)
    b, n = ENC_BLOCK
    toks = torch.randint(0, cfg.vocab_size, (b, n), generator=g)
    frames = torch.randn(b, cfg.encoder_frames, cfg.d_model, generator=g)
    nxt = torch.randint(0, cfg.vocab_size, (b, 1), generator=g)
    errs = {}

    def layer_run(model, c, dev):
        enc = E.encode(model["encdec"], frames.to(dev), c)
        lg, cache = M.prefill(model, {"tokens": toks.to(dev),
                                      "frames": frames.to(dev)}, c,
                              capacity=n + 1)
        dl, _ = M.decode_step(model, nxt.to(dev), cache, n, c)
        return {"encode": enc, "prefill": lg, "ck": cache["ck"],
                "k": cache["k"], "decode": dl}

    cfg1 = dataclasses.replace(cfg, num_layers=1, encoder_layers=1, **f32)
    tree = P.initialize(M.model_specs(cfg1), ENC_SEED, "cuda")
    want = {k: v.float().cpu() for k, v in layer_run(
        M.Model(cfg1, llm_map(lambda t: t.cpu(), tree)), cfg1,
        "cpu").items()}
    got = layer_run(M.Model(cfg1, tree), cfg1, "cuda")
    for k, v in want.items():
        errs[f"f32 {k}"] = close(torch, got[k].cpu(), v, f"encdec b f32 {k}",
                                 ENC_F32_TOL, ENC_F32_TOL)
    cfg16 = dataclasses.replace(cfg1, param_dtype=torch.bfloat16,
                                compute_dtype=torch.bfloat16)
    tree16 = llm_map(lambda t, s: t.to(s.dtype), tree, M.model_specs(cfg16))
    del tree, got
    got = layer_run(M.Model(cfg16, tree16), cfg16, "cuda")
    for k in ("prefill", "decode"):
        errs[f"bf16 {k}"] = close(torch, got[k].cpu(), want[k],
                                  f"encdec b bf16 {k}", **LLM_BF16_VS_F32)
    del tree16, got

    cfg2 = dataclasses.replace(cfg, num_layers=ENC_CUT,
                               encoder_layers=ENC_CUT, **f32)
    tree = P.initialize(M.model_specs(cfg2), ENC_SEED + 1, "cuda")
    x = torch.randn(b, n, cfg.d_model, generator=g)

    def cut_run(tree, dev):
        params = M.Model(cfg2, tree)["encdec"]
        enc = E.encode(params, frames.to(dev), cfg2)
        return enc, E.decode_train(params, enc, x.to(dev), cfg2)

    enc_c, dec_c = cut_run(llm_map(lambda t: t.cpu(), tree), "cpu")
    enc_g, dec_g = cut_run(tree, "cuda")
    errs["f32 cut encode"] = close(torch, enc_g.cpu(), enc_c,
                                   "encdec b cut encode", ENC_F32_TOL,
                                   ENC_F32_TOL)
    errs["f32 cut decode_train"] = close(torch, dec_g.cpu(), dec_c,
                                         "encdec b cut decode_train",
                                         ENC_F32_TOL, ENC_F32_TOL)
    torch.cuda.empty_cache()
    return errs


def enc_timings(torch, M, model, cfg, counts: dict, groups: dict, g) -> list:
    """Part c: prefill over every frame and decode steps, by CUDA events,
    beside their bounds and one profiled call's busy time."""
    f = cfg.encoder_frames
    rows = []
    for b, s in ENC_PREFILL_SHAPES:
        t = torch.randint(0, cfg.vocab_size, (b, s), generator=g).cuda()
        fr = torch.randn(b, f, cfg.d_model, generator=g).cuda()

        def pre(t=t, fr=fr):
            return M.prefill(model, {"tokens": t, "frames": fr}, cfg)

        ms = llm_events_ms(torch, pre, 3)
        busy, kernels = device_busy(pre)
        bound, by, ops = enc_prefill_bound(cfg, counts, groups, b, s, f)
        rows.append(dict(what="prefill", batch=b, tokens=s, frames=f, ms=ms,
                         tokens_per_s=b * s / ms * 1e3, bound_ms=bound,
                         bound_by=by, flops=ops, device_busy_ms=busy,
                         device_ops=kernels))
    for b in LLM_DECODE_BATCHES:
        cache = M.alloc_cache(cfg, b, LLM_DECODE_CACHE, "cuda", frames=f)
        t = torch.randint(0, cfg.vocab_size, (b, 1), generator=g).cuda()

        def step(t=t, cache=cache):
            return M.decode_step(model, t, cache, LLM_DECODE_CACHE - 1, cfg)

        ms = llm_events_ms(torch, step, 10)
        busy, kernels = device_busy(step)
        del cache, step
        bound, by, ops = enc_decode_bound(cfg, groups, b, LLM_DECODE_CACHE, f)
        rows.append(dict(what="decode", batch=b, tokens=LLM_DECODE_CACHE,
                         frames=f, ms=ms, tokens_per_s=b / ms * 1e3,
                         bound_ms=bound, bound_by=by, flops=ops,
                         device_busy_ms=busy, device_ops=kernels))
    return rows


def enc_generate_check(torch, M, E, model, cfg, prompt, fr, tol) -> dict:
    """Part d: generate(frames=) of ENC_GEN_NEW tokens after ``prompt``,
    the same steps by prefill and decode_step (their logits), and one
    full forward over the prompt and the generated tokens: the tokens
    equal the loop's argmax, the logits within ``tol`` of the full
    forward's, and the share of steps whose argmax agrees with it."""
    from repro_torch.serve.serve_step import generate

    n, new = ENC_GEN_PROMPT, ENC_GEN_NEW
    toks, aux = generate(model, cfg, prompt, new, frames=fr)
    if aux["cache"]["ck"].shape[2] != cfg.encoder_frames or aux["cache"][
            "k"].shape[2] != n + new:
        raise AssertionError("encdec d: generate's cache has the wrong "
                             "extents")
    lg, cache = M.prefill(model, {"tokens": prompt, "frames": fr}, cfg,
                          capacity=n + new)
    steps = [lg]
    for i in range(new - 1):
        lg, cache = M.decode_step(model, toks[:, i:i + 1], cache, n + i, cfg)
        steps.append(lg)
    loop = torch.cat(steps, dim=1)
    if not torch.equal(loop.argmax(-1).to(torch.int32), toks):
        raise AssertionError("encdec d: generate's tokens are not the "
                             "greedy tokens of its own steps")
    enc = E.encode(model["encdec"], fr, cfg)
    full_toks = torch.cat([prompt, toks[:, :-1]], dim=1)
    x = E.decode_train(model["encdec"], enc, M._embed(model, full_toks, cfg),
                       cfg)
    full = M._logits(model, x[:, n - 1:], cfg)
    for what, t in (("decode", loop), ("full", full)):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"encdec d: non-finite {what} logits")
    err = close(torch, loop, full, f"encdec d {cfg.compute_dtype} decode vs "
                "full forward", **tol)
    agree = float((loop.argmax(-1) == full.argmax(-1)).float().mean())
    return dict(max_abs_err=err, argmax_agree=agree, prompt=n, new=new)


def phase_encdec(torch):
    """seamless-m4t-medium at full width and depth: parts a-d."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import encdec as E
    from repro_torch.models import model as M
    from repro_torch.models import params as P

    info = {}
    cfg = get_config(ENC_ARCH)
    g = torch.Generator().manual_seed(ENC_SEED)
    torch.cuda.reset_peak_memory_stats()

    # ---- b first: the f32 layers must not sit beside the model
    t0 = time.perf_counter()
    info["card_vs_cpu"] = enc_card_vs_cpu(torch, M, E, P, cfg, g)
    print(f"  encdec b: one encoder and one decoder layer at full width "
          f"({ENC_BLOCK[0]} prompts of {ENC_BLOCK[1]} tokens over "
          f"{cfg.encoder_frames} frames, prefill with its cross cache and "
          f"one decode step) and encode + decode_train over {ENC_CUT} + "
          f"{ENC_CUT} layers: the card (f32, TF32 off) equals the CPU within"
          f" atol = rtol = {ENC_F32_TOL}; bf16 on the card the f32 CPU "
          f"within atol {LLM_BF16_VS_F32['atol']}, rtol "
          f"{LLM_BF16_VS_F32['rtol']}; max abs errors " + ", ".join(
              f"{k} {v:.3g}" for k, v in info["card_vs_cpu"].items())
          + f" ({time.perf_counter() - t0:.1f} s)")

    # ---- a. the model at full width and depth, bf16, on the card
    t0 = time.perf_counter()
    model = M.Model.init(cfg, ENC_SEED, "cuda")
    torch.cuda.synchronize()
    counts = llm_param_counts(cfg)
    groups = enc_groups(cfg)
    held = sum(p.numel() for p in model.parameters())
    held_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    if (counts["params"], counts["bytes"], held, held_bytes) != (
            ENC_PARAMS, ENC_BYTES) * 2:
        raise AssertionError(
            f"{cfg.name}: {counts['params']} parameters in {counts['bytes']}"
            f" bytes ({held} in {held_bytes} on the card), the reference "
            f"counts {ENC_PARAMS} in {ENC_BYTES}")
    info.update(params=counts["params"], param_bytes=counts["bytes"],
                init_s=time.perf_counter() - t0,
                mem_gb=torch.cuda.memory_allocated() / 1e9)
    print(f"  encdec a: {cfg.name} at full width and depth ("
          f"{cfg.encoder_layers} + {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, vocab {cfg.vocab_size}, {cfg.encoder_frames} "
          f"frames): {counts['params']} parameters, {counts['bytes']} bytes,"
          f" the reference's count; initialized on the card in "
          f"{info['init_s']:.2f} s")

    # ---- c. timings
    card = card_name()
    info["card"] = card
    info["timings"] = enc_timings(torch, M, model, cfg, counts, groups, g)
    print_llm_timings("encdec c", card, info["timings"])

    # ---- d. generate(frames=) against the full forward, bf16 and f32
    prompt = torch.randint(0, cfg.vocab_size, (1, ENC_GEN_PROMPT),
                           generator=g).cuda()
    fr = torch.randn(1, cfg.encoder_frames, cfg.d_model, generator=g).cuda()
    info["generate"] = enc_generate_check(torch, M, E, model, cfg, prompt,
                                          fr, ENC_BF16_PATHS)
    del model
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, param_dtype=torch.float32,
                                compute_dtype=torch.float32)
    m32 = M.Model.init(cfg32, ENC_SEED, "cuda")  # the draws before the cast
    info["generate_f32"] = enc_generate_check(torch, M, E, m32, cfg32,
                                              prompt, fr, ENC_F32_PATHS)
    del m32
    torch.cuda.empty_cache()
    for what, d, tol in (("bf16", info["generate"], ENC_BF16_PATHS),
                         ("f32", info["generate_f32"], ENC_F32_PATHS)):
        print(f"  encdec d: {what} generate(frames=) of {d['new']} tokens "
              f"after a {d['prompt']}-token prompt against one full forward "
              f"over both: max abs error {d['max_abs_err']:.3g} (held at "
              f"atol {tol['atol']}, rtol {tol['rtol']}), argmax agreeing on "
              f"{d['argmax_agree']:.3f} of the steps")
    info["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return info


# ---------------------------------------------------------------------------
# 14. training
# ---------------------------------------------------------------------------

TRAIN_SEED = 22
# a: examples/train_embedder.py at its own settings (ckpt_every is its
# max(10, steps // 6)), a fault at steps // 2 as its --inject-fault
TRAIN_EX_ARCH = "minitron-8b"
TRAIN_EX_STEPS, TRAIN_EX_BATCH, TRAIN_EX_SEQ = 300, 8, 64
TRAIN_EX_CKPT, TRAIN_EX_FAULT = 50, 150
# b: gemma2-2b's first block with the embedding and the softcapped logits
# at full width, f32 (TF32 off), the card against the CPU: the loss, the
# global norm and each gradient leaf at TRAIN_GRAD_TOL times the leaf's
# largest magnitude (and rtol), optimizer.apply given the same gradients
# at TRAIN_APPLY_TOL
TRAIN_CMP_ARCH, TRAIN_CMP_TOKENS = "gemma2-2b", (1, 64)
TRAIN_GRAD_TOL, TRAIN_APPLY_TOL = 1e-4, 1e-6
# c: (config, layers or None for its full depth, batch, tokens): the
# sequence is the train_4k shape's, the batch cut from its 256
TRAIN_FULL = (("gemma2-2b", None, 1, 4096),
              ("seamless-m4t-medium", None, 2, 4096),
              ("mamba2-370m", None, 2, 4096),
              ("deepseek-moe-16b", 4, 1, 4096))
TRAIN_TIMED_STEPS = 2


def train_example(torch, root: Path) -> dict:
    """Part a: the example's flow through fit, with a fault and without,
    deterministic; the checks of the reference's test and the example."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.train import fit
    from repro_torch.models import model as M
    from repro_torch.train import optimizer as O
    from repro_torch.train.checkpoint import Checkpointer
    from repro_torch.train.fault import FaultInjector

    cfg = get_smoke_config(TRAIN_EX_ARCH)
    shutil.rmtree(root, ignore_errors=True)
    kw = dict(steps=TRAIN_EX_STEPS, batch=TRAIN_EX_BATCH, seq=TRAIN_EX_SEQ,
              ckpt_every=TRAIN_EX_CKPT, log_every=100, device="cuda")
    saved = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        t0 = time.perf_counter()
        faulty = fit(cfg, ckpt_dir=str(root / "fault"),
                     injector=FaultInjector(fail_at=[TRAIN_EX_FAULT]), **kw)
        faulty_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        clean = fit(cfg, ckpt_dir=str(root / "clean"), **kw)
        clean_s = time.perf_counter() - t0
    finally:
        torch.use_deterministic_algorithms(saved)
    losses = faulty["losses"]
    if faulty["restarts"] != 1 or clean["restarts"] != 0:
        raise AssertionError(f"train a: {faulty['restarts']} restarts with "
                             f"the fault, {clean['restarts']} without")
    if len(losses) != TRAIN_EX_STEPS or losses != clean["losses"]:
        bad = [i for i, (a, b) in enumerate(zip(losses, clean["losses"]))
               if a != b]
        raise AssertionError(f"train a: the replayed losses differ from an "
                             f"uninterrupted run's at steps {bad[:10]}")
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    if not last < first - 0.1:
        raise AssertionError(f"train a: mean loss of the last 5 steps "
                             f"{last:.4f}, of the first 5 {first:.4f}")
    same = all(torch.equal(a, b) for a, b in zip(
        faulty["params"].reference_leaves().values(),
        clean["params"].reference_leaves().values()))
    if not same:
        raise AssertionError("train a: the final parameters differ from an "
                             "uninterrupted run's")
    ck = Checkpointer(str(root / "fault"))
    kept = ck.all_steps()
    for step in kept:  # restore validates every file's sha256
        tmpl = M.Model.init(cfg, 1, "cuda")
        ck.restore({"params": tmpl,
                    "opt_state": O.init(O.OptConfig(), tmpl)}, step)
    if kept[-1] != TRAIN_EX_STEPS or not all(torch.equal(a, b) for a, b in zip(
            tmpl.reference_leaves().values(),
            faulty["params"].reference_leaves().values())):
        raise AssertionError("train a: the last checkpoint is not the final "
                             "state")
    shutil.rmtree(root, ignore_errors=True)
    return dict(config=f"{cfg.name} smoke", params=cfg.param_count(),
                steps=TRAIN_EX_STEPS, batch=TRAIN_EX_BATCH,
                seq=TRAIN_EX_SEQ, fault_at=TRAIN_EX_FAULT,
                restarts=faulty["restarts"],
                stragglers=faulty["stragglers"], loss_first5=first,
                loss_last5=last, replay_bitwise=True,
                checkpoints_verified=kept, seconds_with_fault=faulty_s,
                seconds_clean=clean_s,
                ms_per_step_clean=clean_s / TRAIN_EX_STEPS * 1e3)


def train_card_vs_cpu(torch) -> dict:
    """Part b: one train step's loss and gradients, f32 on the card (TF32
    off) against the CPU, and optimizer.apply on both given the CPU's
    gradients."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import batch_at_step
    from repro_torch.models import model as M
    from repro_torch.models import params as P
    from repro_torch.train import optimizer as O
    from repro_torch.train.train_step import loss_and_grads

    cfg = dataclasses.replace(get_config(TRAIN_CMP_ARCH), num_layers=2,
                              param_dtype=torch.float32,
                              compute_dtype=torch.float32)
    b, s = TRAIN_CMP_TOKENS
    tree = P.initialize(M.model_specs(cfg), TRAIN_SEED, "cuda")
    card = M.Model(cfg, tree)
    cpu = M.Model(cfg, llm_map(lambda t: t.cpu(), tree))
    batch = batch_at_step(TRAIN_SEED, 0, b, s, cfg.vocab_size)
    out = {}
    t0 = time.perf_counter()
    lg, _, gg = loss_and_grads(card, {k: v.cuda() for k, v in batch.items()},
                               cfg)
    torch.cuda.synchronize()
    out["card_grads_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    lc, _, gc = loss_and_grads(cpu, batch, cfg)
    out["cpu_grads_s"] = time.perf_counter() - t0
    gc_card = {k: v.cuda() for k, v in gc.items()}  # compared on the card
    tol = TRAIN_GRAD_TOL
    out["loss"] = close(torch, lg.cpu(), lc, "train b loss", tol, tol)
    out["loss_value"] = float(lc)
    out["grad_norm"] = close(torch, O.global_norm(gg), O.global_norm(
        gc_card), "train b grad norm", tol, tol)
    worst = 0.0
    for k, want in gc_card.items():
        scale = max(float(want.abs().max()), 1e-30)
        err = close(torch, gg[k], want, f"train b grad {k}", tol * scale, tol)
        worst = max(worst, err / scale)
    out["grad_leaves"] = len(gc)
    out["grad_worst_rel"] = worst
    del gg
    ocfg = O.OptConfig(lr=1e-3, warmup_steps=1, total_steps=100)
    O.apply(ocfg, card, gc_card, O.init(ocfg, card))
    t0 = time.perf_counter()
    O.apply(ocfg, cpu, gc, O.init(ocfg, cpu))
    out["cpu_apply_s"] = time.perf_counter() - t0
    got, want = card.reference_leaves(), cpu.reference_leaves()
    out["apply"] = max(close(torch, got[k], want[k].cuda(), f"train b apply "
                             f"{k}", TRAIN_APPLY_TOL, TRAIN_APPLY_TOL)
                       for k in want)
    del card, cpu, tree, gc, gc_card, got, want
    torch.cuda.empty_cache()
    return out


def train_bound(cfg, counts: dict, b: int, s: int, state_bytes: int
                ) -> tuple:
    """3 x the forward's operations (every position's logits; the
    recomputation not counted) over the peaks, against the parameters
    read twice and written once, the gradients written and read, and the
    moments read and written."""
    if cfg.is_encdec:
        fwd = enc_forward_ops(cfg, enc_groups(cfg), b, s,
                              cfg.encoder_frames, s)
        f32 = 0
    else:
        _, _, ops = llm_prefill_bound(cfg, counts, b, s)
        f32 = llm_ssd_ops(cfg, b, s)
        fwd = ops - f32 + 2 * b * (s - 1) * cfg.d_model * cfg.vocab_size
    n_bytes = 5 * counts["bytes"] + 2 * state_bytes
    return llm_bound(n_bytes, 3 * fwd, 3 * f32)


def train_full(torch, g) -> list:
    """Part c: AdamW steps at full width, timed by CUDA events."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import batch_at_step
    from repro_torch.models import model as M
    from repro_torch.train import optimizer as O
    from repro_torch.train.train_step import build_train_step

    rows = []
    for arch, layers, b, s in TRAIN_FULL:
        t_arch = time.perf_counter()
        cfg = get_config(arch)
        if layers:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model = M.Model.init(cfg, TRAIN_SEED, "cuda")
        ocfg = O.OptConfig(lr=1e-4, warmup_steps=1, total_steps=100)
        state = {"opt": O.init(ocfg, model), "metrics": []}
        batch = {k: v.cuda() for k, v in batch_at_step(
            TRAIN_SEED, 0, b, s, cfg.vocab_size).items()}
        if cfg.is_encdec:
            batch["frames"] = torch.randn(
                b, cfg.encoder_frames, cfg.d_model, generator=g).to(
                "cuda", cfg.compute_dtype)
        step_fn = build_train_step(cfg, ocfg)

        def step():
            _, state["opt"], m = step_fn(model, state["opt"], batch)
            state["metrics"].append((m["loss"], m["grad_norm"]))

        ms = llm_events_ms(torch, step, TRAIN_TIMED_STEPS)
        busy, kernels = device_busy(step)
        losses = [float(loss) for loss, _ in state["metrics"]]
        norms = [float(n) for _, n in state["metrics"]]
        if not all(np.isfinite(losses + norms)):
            raise AssertionError(f"train c {arch}: non-finite losses {losses}"
                                 f" or gradient norms {norms}")
        counts = llm_param_counts(cfg)
        state_bytes = sum(t.numel() * t.element_size()
                          for t in state["opt"].mu.values()) * 2
        bound, by, ops = train_bound(cfg, counts, b, s, state_bytes)
        rows.append(dict(
            config=arch, layers=cfg.num_layers, batch=b, tokens=s,
            params=counts["params"], steps=len(losses), ms=ms,
            tokens_per_s=b * s / ms * 1e3, bound_ms=bound, bound_by=by,
            flops=ops, device_busy_ms=busy, device_ops=kernels,
            peak_gb=torch.cuda.max_memory_allocated() / 1e9,
            losses=losses, grad_norms=norms,
            seconds=time.perf_counter() - t_arch))
        del model, state, batch, step_fn, step
        torch.cuda.empty_cache()
    return rows


def phase_train(torch, root: Path):
    """Parts a-c of the training phase."""
    info = {}
    t0 = time.perf_counter()
    info["example"] = train_example(torch, root)
    a = info["example"]
    print(f"  train a: examples/train_embedder.py's flow on the card "
          f"({a['config']}, {a['params']} parameters, {a['steps']} steps of "
          f"{a['batch']} x {a['seq']}, a fault at step {a['fault_at']}): "
          f"{a['restarts']} restart, {a['stragglers']} stragglers, mean loss "
          f"{a['loss_first5']:.4f} over the first 5 steps and "
          f"{a['loss_last5']:.4f} over the last 5; losses and final "
          f"parameters equal to an uninterrupted run's bit for bit "
          f"(deterministic algorithms on); checkpoints of steps "
          f"{a['checkpoints_verified']} pass their sha256 check; "
          f"{a['ms_per_step_clean']:.1f} ms a step "
          f"({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    info["card_vs_cpu"] = train_card_vs_cpu(torch)
    bcmp = info["card_vs_cpu"]
    print(f"  train b: {TRAIN_CMP_ARCH}'s first block with the embedding and"
          f" the softcapped logits at full width, {TRAIN_CMP_TOKENS[0]} x "
          f"{TRAIN_CMP_TOKENS[1]} tokens, f32: the card (TF32 off) equals the"
          f" CPU; loss {bcmp['loss_value']:.4f} within {bcmp['loss']:.3g}, "
          f"the global norm within {bcmp['grad_norm']:.3g}, the "
          f"{bcmp['grad_leaves']} gradient leaves within "
          f"{bcmp['grad_worst_rel']:.3g} of each leaf's largest magnitude "
          f"(held at {TRAIN_GRAD_TOL}); optimizer.apply given the same "
          f"gradients within {bcmp['apply']:.3g} (held at {TRAIN_APPLY_TOL})"
          f"; gradients {bcmp['card_grads_s']:.2f} s on the card, "
          f"{bcmp['cpu_grads_s']:.1f} s on the CPU, the CPU's update "
          f"{bcmp['cpu_apply_s']:.1f} s ({time.perf_counter() - t0:.1f} s)")
    info["card"] = card = card_name()
    info["steps"] = train_full(torch, torch.Generator().manual_seed(
        TRAIN_SEED))
    print(f"  train c: AdamW steps at full width, bf16 weights and f32 "
          f"moments, timed by CUDA events on {card} (mean of "
          f"{TRAIN_TIMED_STEPS} steps after a warm one):")
    for r in info["steps"]:
        print(f"    {r['config']:20s} {r['layers']:2d} layers {r['batch']} x "
              f"{r['tokens']}: {r['ms']:9.1f} ms a step, "
              f"{r['tokens_per_s']:9.1f} tokens/s, bound {r['bound_ms']:.1f} "
              f"ms ({r['bound_by']}), {r['bound_ms'] / r['ms']:.3f} of it; "
              f"the device busy {r['device_busy_ms']:.1f} ms of a profiled "
              f"step ({r['device_ops']} kernels and copies); peak "
              f"{r['peak_gb']:.1f} GB allocated; losses "
              + ", ".join(f"{v:.4f}" for v in r["losses"]))
    return info


# the roofline phase (15): the paper's search cell at the reference's
# dryrun_search settings on the main path's collection (n_per_shard cut
# from 2,000,000 to the collection's 2^20 for host time), solo and
# cooperative; then every production decode cell that the dry run says
# fits one card whole, at full width and depth, bf16 weights from
# ROOF_SEED, gemma2-2b long_500k first on an emptied card
ROOF_LEAF_CAP, ROOF_QUERIES, ROOF_QSEED = 512, 256, 11
ROOF_K, ROOF_NPROBE, ROOF_VB = 100, 128, 8
ROOF_SEED = 23
ROOF_FIRST = ("gemma2-2b", "long_500k")
ROOF_AT_LEAST = (("gemma2-2b", "long_500k"), ("mamba2-370m", "decode_32k"),
                 ("mamba2-370m", "long_500k"))


def roof_line(label: str, rep: dict) -> str:
    t, m = rep["terms_seconds"], rep["memory_analysis"]
    return (f"  {label}: {rep['measured_seconds'] * 1e3:.3f} ms a step, "
            f"busy {rep['busy_seconds'] * 1e3:.3f} ms (idle share "
            f"{rep['idle_share']:.3f}, {rep['kernels']} kernels and "
            f"copies); analytic compute {t['compute'] * 1e3:.4f} ms, "
            f"memory {t['memory'] * 1e3:.4f} ms: roofline share "
            f"{rep['roofline_share']:.4f} ({rep['roofline_bound']}); "
            f"meta live {m['live_bytes'] / 1e9:.2f} GB, "
            f"max_memory_allocated {rep['peak_bytes'] / 1e9:.2f} GB; "
            f"{rep['device']}")


def roof_search(torch, S, data, data_t, path) -> list:
    """(a) The search cell: a DSTree at ROOF_LEAF_CAP over the collection,
    ROOF_QUERIES noisy queries (seed ROOF_QSEED),
    ``dryrun_search.lower_search`` measured solo and with share_gathers
    (K1, K4 and lex_select), then one more search of each recorded by
    ``path``. Every returned distance must be its id's true distance;
    recall against brute force is reported."""
    from repro_torch.core.indexes import dstree
    from repro_torch.core.metrics import workload_metrics
    from repro_torch.data import queries
    from repro_torch.launch import dryrun_search

    q_t = torch.as_tensor(queries.noisy_queries(data, ROOF_QUERIES,
                                                seed=ROOF_QSEED),
                          device="cuda")
    truth = S.brute_force(q_t, data_t, ROOF_K, device="cuda")
    t0 = time.perf_counter()
    idx = dstree.build(data, leaf_cap=ROOF_LEAF_CAP, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n, length = data.shape
    dist = sq_dist64(torch, q_t, data_t, torch.arange(n, device="cuda"))
    reps = []
    for coop in (False, True):
        rep = dryrun_search.lower_search(
            n_per_shard=n, series_len=length, leaf_cap=ROOF_LEAF_CAP,
            batch=ROOF_QUERIES, k=ROOF_K, nprobe=ROOF_NPROBE,
            visit_batch=ROOF_VB, coop=coop, index=idx, queries=q_t)
        with path:
            res = S.search_impl(idx, q_t, ROOF_K, nprobe=ROOF_NPROBE,
                                visit_batch=ROOF_VB, share_gathers=coop)
        if res.dists.shape != (ROOF_QUERIES, ROOF_K) or not bool(
                torch.isfinite(res.dists).all()):
            raise AssertionError("roofline search: wrong shape or a "
                                 "non-finite distance")
        err = dist_close(torch, res.dists.double() ** 2, dist(res.ids),
                         f"roofline search coop={coop}: returned distances")
        m = workload_metrics(res.ids, res.dists, truth.ids, truth.dists)
        rep.update(variant="coop" if coop else "solo", build_s=build_s,
                   dist_err=err,
                   recall=m["avg_recall"], map=m["map"],
                   reduced="n_per_shard cut from 2,000,000 to "
                           f"{n:,} for host time")
        reps.append(rep)
    del idx
    return reps


def roof_decode_cell(torch, arch: str, shape_name: str, g) -> dict:
    """(b) One production decode cell at full width and depth on the
    card: the dry run's report (``lower_cell`` on meta), then bf16
    weights from ROOF_SEED, the cache at the shape's capacity, one warm
    step at pos = seq - 1, 3 timed and one profiled
    (``roofline.profile_device``); the logits finite. The bound
    chip_smoke's LLM phases use (``llm_decode_bound``) beside the
    analytic terms."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch import roofline as roof
    from repro_torch.models import model as M

    cfg, sh = get_config(arch), SHAPES[shape_name]
    if sh.kind != "decode":
        raise AssertionError(f"{arch} {shape_name} fits one card by the dry "
                             f"run, and phase 15 runs only decode cells")
    t0 = time.perf_counter()
    rep = dryrun.lower_cell(arch, shape_name)
    meta_s = time.perf_counter() - t0
    held = torch.cuda.memory_allocated()
    model = M.Model.init(cfg, ROOF_SEED, "cuda")
    cache = M.alloc_cache(cfg, sh.batch, sh.seq, "cuda")
    toks = torch.randint(0, cfg.vocab_size, (sh.batch, 1),
                         generator=g).cuda()
    out = []

    def step():
        out[:] = [M.decode_step(model, toks, cache, sh.seq - 1, cfg)[0]]

    with torch.no_grad():
        measured = roof.profile_device(step, inputs=(toks,))
    logits = out[0]
    if logits.shape != (sh.batch, 1, cfg.vocab_size) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError(f"{arch} {shape_name}: decode logits of the "
                             "wrong shape or not finite")
    roof.add_measured(rep, measured)
    bound, by, ops = llm_decode_bound(cfg, llm_param_counts(cfg), sh.batch,
                                      sh.seq)
    rep.update(meta_s=meta_s, held_before_bytes=held, smoke_bound_ms=bound,
               smoke_bound_by=by, smoke_bound_ops=ops)
    del model, cache, out, logits, step
    torch.cuda.empty_cache()
    return rep


def phase_roofline(torch, S, data, data_t, path) -> dict:
    """Phase 15: the search cell, then the production decode cells the dry
    run (``dryrun.fits_hbm``, meta) says fit; their reports."""
    from repro_torch.configs import ARCH_IDS, SHAPES
    from repro_torch.launch import dryrun

    t0 = time.perf_counter()
    search = roof_search(torch, S, data, data_t, path)
    held = path.check("roofline")
    search_s = time.perf_counter() - t0
    for rep in search:
        print(roof_line(f"search {rep['variant']} ("
                        f"{rep['search']['loop_iterations']} iterations, "
                        f"recall {rep['recall']:.3f})", rep))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    fits = {(a, s): dryrun.fits_hbm(a, s) for a in ARCH_IDS for s in SHAPES}
    fit_s = time.perf_counter() - t0
    cells = [c for c, f in fits.items() if f["fits_hbm"]]
    missing = [c for c in ROOF_AT_LEAST if c not in cells]
    if missing:
        raise AssertionError(f"the dry run says these cells do not fit one "
                             f"card: {missing}")
    cells.sort(key=lambda c: c != ROOF_FIRST)
    print(f"  cells that fit one card by the dry run ({fit_s:.1f} s on the "
          f"host, meta): {cells}")
    g = torch.Generator().manual_seed(ROOF_SEED)
    reports = []
    for arch, shape in cells:
        rep = roof_decode_cell(torch, arch, shape, g)
        print(roof_line(f"{arch} {shape}", rep)
              + f"; chip_smoke's decode bound {rep['smoke_bound_ms']:.4f} ms"
              f" ({rep['smoke_bound_by']})")
        reports.append(rep)
    return {"search": search, "cells": reports, "held": len(held),
            "search_s": search_s, "fits_s": fit_s,
            "total_memory": torch.cuda.get_device_properties(0).total_memory}


# the engine across ranks (phase 16): MESH_ROWS name: (guarantee, sync_bsf,
# share_gathers), each on the mesh engine and the one-card engine; the
# out-of-core row repeats MESH_OOC_ROW from the spill; the profiled query
MESH_LEAF_CAP = 256
MESH_ROWS = {
    "exact": ("exact", False, False),
    "eps=1": ("eps", False, False),
    "d=.99,eps=1": ("delta_eps", False, False),
    "ng(4)": ("ng", False, False),
    "ng(4)+share": ("ng", False, True),
    "exact+sync": ("exact", True, False),
}
MESH_OOC_ROW = "eps=1"


@contextlib.contextmanager
def uncounted(wrappers):
    """Launches inside do not count: the wrappers' counts are restored on
    the way out. For comparators a phase runs beside its path."""
    saved = {name: fn.launches for name, fn in wrappers.items()}
    try:
        yield
    finally:
        for name, fn in wrappers.items():
            fn.launches = saved[name]


def mesh_guarantee(G, name: str):
    return {"exact": G.exact(), "eps": G.epsilon(1.0),
            "delta_eps": G.delta_epsilon(0.99, 1.0), "ng": G.ng(4)}[name]


def mesh_collectives(torch, fn) -> dict:
    """The collectives one call of fn issues, from torch.profiler: NCCL
    kernels on the card (count and device ms) and c10d operations on the
    host (by name); and the aten calls on the host, all of them and the
    outermost (those that no other aten call made: the calls the program
    and autograd dispatch, a DTensor's local calls nested below them)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels, ms, ops, aten, outer = 0, 0.0, {}, 0, 0
    for e in prof.events():
        on_card = str(e.device_type).rsplit(".", 1)[-1] == "CUDA"
        name = e.name
        if on_card and "nccl" in name.lower():
            kernels += 1
            ms += e.time_range.elapsed_us() / 1e3
        elif not on_card and name.startswith(("c10d::", "nccl:")):
            ops[name] = ops.get(name, 0) + 1
        if not on_card and name.startswith("aten::"):
            aten += 1
            up = e.cpu_parent
            while up is not None and not up.name.startswith("aten::"):
                up = up.cpu_parent
            outer += up is None
    return {"nccl_kernels": kernels, "nccl_kernel_ms": ms, "host_ops": ops,
            "aten_calls": aten, "outer_aten_calls": outer}


def phase_mesh(torch, S, G, data, data_t, q, truth, k, dist64, root: Path,
               path) -> dict:
    """Phase 16: the engine across ranks at world 1 over NCCL against the
    one-card engine; returns the phase's rows and numbers. The process
    group is destroyed before it returns or raises."""
    import torch.distributed as dist

    from repro_torch.core.engine import DistributedEngine
    from repro_torch.core.metrics import workload_metrics
    from repro_torch.core.spec import IndexSpec, StoreSpec
    from repro_torch.kernels import ref
    from repro_torch.launch import mesh as M

    ispec = IndexSpec("dstree", leaf_cap=MESH_LEAF_CAP)
    info, rows, times = {}, [], {}
    eng = one = None
    t0 = time.perf_counter()
    dev = M.init_world("cuda")
    try:
        mesh = M.make_test_mesh((1, 1), ("data", "model"), device="cuda")
        info.update(world=dist.get_world_size(), backend=dist.get_backend(),
                    mesh=M.mesh_axis_sizes(mesh), device=str(dev),
                    world_s=time.perf_counter() - t0)
        if info["backend"] != "nccl":
            raise AssertionError(f"mesh phase: the world runs "
                                 f"{info['backend']}, not nccl")
        # brute force and the one-card engine are comparators beside the
        # mesh path: they run uncounted and unrecorded, so the counts and
        # the held inputs are the mesh engine's alone
        with uncounted(path.wrappers):
            t0 = time.perf_counter()
            bf = S.brute_force(q, data_t, k, device="cuda")
            torch.cuda.synchronize()
            times["brute_force"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            one = DistributedEngine(shards=1, device="cuda").build(
                data, index=ispec)
            torch.cuda.synchronize()
            times["build_one_card"] = time.perf_counter() - t0
        with path:
            t0 = time.perf_counter()
            eng = DistributedEngine(mesh=mesh, axes=("data",),
                                    device="cuda").build(
                data, index=ispec, store=StoreSpec(spill_dir=str(root)))
            torch.cuda.synchronize()
            times["build_mesh"] = time.perf_counter() - t0
        if not (torch.equal(bf.ids, truth.ids)
                and torch.equal(bf.dists, truth.dists)):
            raise AssertionError("mesh phase: brute force differs from "
                                 "phase 5's")
        got = {}
        for ri, (rname, (gname, sync, share)) in enumerate(MESH_ROWS.items()):
            g = mesh_guarantee(G, gname)
            pair = {}
            # the two engines take turns at going first
            order = (("mesh", eng), ("one_card", one))
            for which, e in order[::-1] if ri % 2 else order:
                with (path if which == "mesh"
                      else uncounted(path.wrappers)):
                    t0 = time.perf_counter()
                    res = e.query(q, k, g, sync_bsf=sync, share_gathers=share)
                    torch.cuda.synchronize()
                    pair[which] = (res, time.perf_counter() - t0)
            (a, sec), (b, sec1) = pair["mesh"], pair["one_card"]
            what = f"mesh {rname}"
            for x, y, field in zip(a[:4], b[:4], ("dists", "ids", "leaves",
                                                   "rows")):
                if not torch.equal(x, y):
                    raise AssertionError(f"{what}: {field} differ from the "
                                         "one-card engine's")
            if (a.lb_computed, a.iterations) != (b.lb_computed, b.iterations):
                raise AssertionError(f"{what}: lb_computed or iterations "
                                     "differ from the one-card engine's")
            if a.dists.shape != (q.shape[0], k) or not bool(
                    torch.isfinite(a.dists[:, 0]).all()):
                raise AssertionError(f"{what}: wrong shape or no finite "
                                     "nearest neighbour")
            m = workload_metrics(a.ids, a.dists, truth.ids, truth.dists)
            swaps = None
            if gname == "exact":
                if f"{m['map']:.3f}" != "1.000":
                    raise AssertionError(f"{what}: MAP {m['map']} on an "
                                         "exact row")
                swaps = ties_only(torch, a.ids, truth.ids, dist64, what)
            got[rname] = a
            rows.append(dict(row=rname, map=m["map"], recall=m["avg_recall"],
                             mre=m["mre"], leaves=float(
                                 a.leaves_visited.float().mean()),
                             iterations=a.iterations[0], ms=sec * 1e3,
                             one_card_ms=sec1 * 1e3, swaps=swaps))
            print(f"  mesh {rname}: {sec:.2f} s (one card {sec1:.2f} s), "
                  f"{a.iterations[0]} iterations, bit-equal")
        with path:
            t0 = time.perf_counter()
            ooc = eng.query(q, k, mesh_guarantee(
                G, MESH_ROWS[MESH_OOC_ROW][0]), ooc=True)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
        # ids at bit-equal distances may come in another order: the
        # resident merge keeps the shards' order among equal distances, the
        # out-of-core fold orders them by id (as the reference's two do)
        want = got[MESH_OOC_ROW]
        tied = int((ooc.ids != want.ids).sum())
        for x, y, field in zip(
                (ooc.dists, ooc.ids.gather(1, ref.lex_order(ooc.dists,
                                                            ooc.ids)),
                 ooc.leaves_visited, ooc.rows_scanned),
                (want.dists, want.ids.gather(1, ref.lex_order(want.dists,
                                                              want.ids)),
                 want.leaves_visited, want.rows_scanned),
                ("dists", "ids", "leaves", "rows")):
            if not torch.equal(x, y):
                raise AssertionError(f"mesh {MESH_OOC_ROW} out of core: "
                                     f"{field} differ from the resident "
                                     "row's")
        st = ooc.stats
        same = next(r for r in rows if r["row"] == MESH_OOC_ROW)
        rows.append(dict(row=f"{MESH_OOC_ROW} ooc", map=same["map"],
                         recall=same["recall"], mre=same["mre"],
                         leaves=float(ooc.leaves_visited.float().mean()),
                         iterations=ooc.iterations[0], ms=sec * 1e3,
                         one_card_ms=None, swaps=tied,
                         bytes_read=st.bytes_read, hit_rate=st.hit_rate))
        print(f"  mesh {MESH_OOC_ROW} out of core: {sec:.2f} s, "
              f"{st.bytes_read / 1e9:.2f} GB read, equal to resident "
              f"({tied} ids in another order among equal distances)")
        info["held"] = len(path.check("mesh"))

        def profiled():
            eng.query(q, k, G.ng(4), sync_bsf=True)

        profiled()
        info["collectives"] = mesh_collectives(torch, profiled)
        info.update(times)
        info["rows"] = rows
        return info
    finally:
        for e in (eng, one):
            if e is not None:
                e.close()
        del eng, one
        shutil.rmtree(root, ignore_errors=True)
        M.destroy_world()


def print_mesh_table(rows) -> None:
    hdr = (f"{'row':13s} {'MAP':>6s} {'recall':>7s} {'MRE':>7s} "
           f"{'leaves':>7s} {'iters':>6s} {'ms':>9s} {'one-card ms':>11s}")
    print(hdr)
    print("-" * len(hdr))
    for r in rows:
        one = "" if r["one_card_ms"] is None else f"{r['one_card_ms']:11.1f}"
        print(f"{r['row']:13s} {r['map']:6.3f} {r['recall']:7.3f} "
              f"{r['mre']:7.4f} {r['leaves']:7.0f} {r['iterations']:6d} "
              f"{r['ms']:9.1f} {one}")


# the train-across-ranks phase (17): TRAIN_MESH_ARCH at full width and
# depth in bf16, weights from TRAIN_MESH_SEED, through fit(mesh=) on a
# (1, 1) ("data", "model") mesh over NCCL at world 1, then the one-card
# fit from the same seed, with torch.use_deterministic_algorithms on for
# both; losses at TRAIN_MESH_LOSS_RTOL and each parameter leaf at
# TRAIN_MESH_PARAM_TOL times its largest magnitude (one bf16 step), and
# then bit for bit, required (at world 1 every placement replicates and
# the collectives move nothing; the leaves and losses that differ are
# named); then
# compressed_psum over TRAIN_MESH_LEAF's full-width gradient, bit-equal to
# the local quantize-dequantize at world 1
TRAIN_MESH_ARCH, TRAIN_MESH_SEED = "gemma2-2b", 24
TRAIN_MESH_STEPS, TRAIN_MESH_BATCH, TRAIN_MESH_SEQ = 2, 1, 2048
TRAIN_MESH_LOSS_RTOL, TRAIN_MESH_PARAM_TOL = 1e-5, 2.0 ** -8
TRAIN_MESH_LEAF = "blocks.sub0.mlp.wi_gate"


@contextlib.contextmanager
def timed_steps(torch, times: list):
    """Every train step that launch/train.fit builds inside, timed on its
    own (synchronized before and after) into ``times``."""
    from repro_torch.launch import train as T

    real = T.build_train_step

    def build(*args, **kw):
        fn = real(*args, **kw)

        def step(*a):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            return out

        return step

    T.build_train_step = build
    try:
        yield
    finally:
        T.build_train_step = real


def phase_train_mesh(torch) -> dict:
    """Phase 17: training across ranks at world 1 over NCCL against the
    one-card fit. The process group is destroyed before it returns or
    raises."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import batch_at_step
    from repro_torch.launch import mesh as M
    from repro_torch.launch import sharding as SH
    from repro_torch.launch.train import batch_rows, fit
    from repro_torch.models.sharding_utils import use_mesh
    from repro_torch.train import compress as C
    from repro_torch.train import optimizer as O
    from repro_torch.train.train_step import build_train_step, loss_and_grads

    cfg = get_config(TRAIN_MESH_ARCH)
    b, s, steps = TRAIN_MESH_BATCH, TRAIN_MESH_SEQ, TRAIN_MESH_STEPS
    kw = dict(steps=steps, batch=b, seq=s, seed=TRAIN_MESH_SEED,
              device="cuda")
    info = dict(config=cfg.name, layers=cfg.num_layers, batch=b, seq=s,
                steps=steps, params=cfg.param_count())
    saved = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    t0 = time.perf_counter()
    M.init_world("cuda")
    try:
        mesh = M.make_mesh((1, 1), ("data", "model"), "cuda")
        info.update(world=dist.get_world_size(), backend=dist.get_backend(),
                    mesh=M.mesh_axis_sizes(mesh),
                    world_s=time.perf_counter() - t0)
        if info["backend"] != "nccl":
            raise AssertionError(f"train mesh: the world runs "
                                 f"{info['backend']}, not nccl")
        times = []
        t0 = time.perf_counter()
        with timed_steps(torch, times):
            got = fit(cfg, mesh=mesh, **kw)
        info["mesh_fit_s"] = time.perf_counter() - t0
        info["mesh_step_s"] = times
        leaves = got["params"].reference_leaves()
        want = SH.by_path(SH.param_shardings(cfg, mesh))
        bad = [k for k, v in leaves.items() if not isinstance(v, DTensor)
               or tuple(v.placements) != want[k]]
        bad += [k for k, v in got["opt_state"].mu.items()
                if tuple(v.placements) != want[k]]
        if bad:
            raise AssertionError(f"train mesh: leaves not laid out by the "
                                 f"rules: {bad[:5]}")
        host = {k: v.to_local().to("cpu", copy=True)
                for k, v in leaves.items()}
        mesh_losses = list(got["losses"])
        # one more step on the mesh, profiled for its collectives (the
        # parameters it leaves are not compared)
        ocfg = O.OptConfig(lr=1e-3, warmup_steps=min(20, steps // 5 + 1),
                           total_steps=steps)
        step_fn = build_train_step(cfg, ocfg)
        start, rows, pl = batch_rows(mesh, b)
        batch = batch_at_step(TRAIN_MESH_SEED, steps, b, s, cfg.vocab_size,
                              row_start=start, row_count=rows)
        dbatch = {k: DTensor.from_local(v.cuda(), mesh, pl)
                  for k, v in batch.items()}

        def one_step():
            with use_mesh(mesh):
                step_fn(got["params"], got["opt_state"], dbatch)

        info["collectives"] = mesh_collectives(torch, one_step)
        del got, leaves, step_fn, dbatch
        torch.cuda.empty_cache()

        times = []
        t0 = time.perf_counter()
        with timed_steps(torch, times):
            one = fit(cfg, **kw)
        info["one_card_fit_s"] = time.perf_counter() - t0
        info["one_card_step_s"] = times
        info["mesh_losses"], info["one_card_losses"] = mesh_losses, list(
            one["losses"])
        for i, (x, y) in enumerate(zip(mesh_losses, one["losses"])):
            if abs(x - y) > TRAIN_MESH_LOSS_RTOL * abs(y):
                raise AssertionError(f"train mesh: step {i} loss {x} on the "
                                     f"mesh, {y} on one card")
        diffs, equal = {}, True
        for k, v in one["params"].reference_leaves().items():
            mine = host.pop(k).cuda()
            equal &= torch.equal(mine, v)
            d = float((mine.float() - v.float()).abs().max())
            scale = max(float(v.float().abs().max()), 1e-30)
            diffs[k] = d
            if d > TRAIN_MESH_PARAM_TOL * scale:
                raise AssertionError(f"train mesh: {k} differs by {d} "
                                     f"(largest magnitude {scale})")
        info["param_max_diff"] = diffs
        info["bit_equal"] = bool(equal and mesh_losses == one["losses"])
        if not info["bit_equal"]:
            # every placement replicates at world 1: DTensor only wraps
            apart = [k for k, d in diffs.items() if d] + [
                f"loss {i}" for i, (x, y) in enumerate(zip(
                    mesh_losses, one["losses"])) if x != y]
            raise AssertionError(f"train mesh: not bit-equal to one card "
                                 f"at world 1: {apart[:5]}")

        # one more step on one card, profiled: its aten calls beside the
        # mesh step's (the parameters it leaves are not used again)
        one_step_fn = build_train_step(cfg, ocfg)
        one_batch = {k: v.cuda() for k, v in batch.items()}
        info["one_card_collectives"] = mesh_collectives(
            torch, lambda: one_step_fn(one["params"], one["opt_state"],
                                       one_batch))
        del one_step_fn, one_batch

        # compressed_psum over a full-width gradient leaf at world 1
        plain = {k: v.cuda() for k, v in batch_at_step(
            TRAIN_MESH_SEED, 0, b, s, cfg.vocab_size).items()}
        _, _, grads = loss_and_grads(one["params"], plain, cfg)
        g = grads[TRAIN_MESH_LEAF]
        del grads
        q, scale = C._quantize(g.float())
        local = C._dequantize(q, scale).to(g.dtype)
        psum = C.compressed_psum(g)
        if not torch.equal(psum, local):
            raise AssertionError("train mesh: compressed_psum at world 1 "
                                 "differs from the local quantization")
        info["psum"] = dict(
            leaf=TRAIN_MESH_LEAF, shape=list(g.shape), dtype=str(g.dtype),
            ms=cuda_ms(torch, lambda: C.compressed_psum(g), 5),
            local_ms=cuda_ms(torch, lambda: C._dequantize(
                *C._quantize(g.float())).to(g.dtype), 5),
            bit_equal=True)
        del one, g, q, local, psum
        torch.cuda.empty_cache()
        return info
    finally:
        torch.use_deterministic_algorithms(saved)
        M.destroy_world()


# the dry-run step's subprocess: its bound in seconds, and its program
DRY_TIMEOUT = 120
DRY_RUN = """
import json
from repro_torch.clock import now
from repro_torch.launch import dryrun, dryrun_search
from repro_torch.launch import mesh as M

def brief(rep, t):
    m = rep["memory_analysis"]
    return {k: rep[k] for k in ("status", "world", "mesh", "mesh_axes",
                                "bottleneck", "n_collectives",
                                "wire_bytes_by_kind", "terms_seconds")} | {
        "live_gib": m["live_bytes"] / 2 ** 30, "fits_hbm": m["fits_hbm"],
        "seconds": t}

t0 = now()
mesh = M.make_production_mesh(dry=True)
try:
    cell = dryrun.lower_cell("gemma2-2b", "decode_32k", mesh)
finally:
    M.destroy_world()
t1 = now()
mesh = M.make_production_mesh(multi_pod=True, dry=True)
try:
    search = dryrun_search.lower_search(mesh)
finally:
    M.destroy_world()
out = {"decode_32k": brief(cell, t1 - t0) | {"arch": cell["arch"]},
       "search": brief(search, now() - t1)
       | {"n_total_series": search["n_total_series"]}}
print("DRY " + json.dumps(out))
"""


def phase_dry_run() -> dict:
    """The dry run at the production meshes, in a subprocess bounded at
    DRY_TIMEOUT seconds: gemma2-2b decode_32k on the 16 x 16 dry mesh and
    the search cell on the 2 x 16 x 16 one. Raises unless both give
    status ok and recorded collectives."""
    import subprocess

    src = str(Path(__file__).resolve().parent / "src")
    env = dict(os.environ, PYTHONPATH=src + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", DRY_RUN], env=env,
                          capture_output=True, text=True,
                          timeout=DRY_TIMEOUT)
    if proc.returncode != 0:
        raise AssertionError(f"the dry run failed (rc {proc.returncode}):\n"
                             f"{proc.stderr[-3000:]}")
    line = next(ln for ln in proc.stdout.splitlines()
                if ln.startswith("DRY "))
    info = json.loads(line[len("DRY "):])
    for name, rep in info.items():
        if rep["status"] != "ok" or rep["n_collectives"] < 1:
            raise AssertionError(f"dry run {name}: status {rep['status']}, "
                                 f"{rep['n_collectives']} collectives")
    return info


def phase_done(n: int, name: str, t0: float) -> float:
    """A phase's wall seconds, printed on a line of their own."""
    sec = time.perf_counter() - t0
    print(f"phase {n} {name}: {sec:.1f} s")
    return sec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-series", type=int, default=1 << 20)
    args = ap.parse_args()
    sys.stdout.reconfigure(line_buffering=True)
    tp = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from repro_torch.core import guarantees as G
    from repro_torch.core import search as S
    from repro_torch.core.indexes import (dstree, graph, imi, isax, qalsh,
                                          srs, vafile)
    from repro_torch.data import queries, randomwalk
    from repro_torch.kernels import build, ops, ref

    # exact answers compare f32 distances: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    print(card_name())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    phase_done(1, "environment", tp)

    tp = t0 = time.perf_counter()
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
    phase_done(2, "build", tp)

    tp = t0 = time.perf_counter()
    phase_ragged(torch, ops, ref)
    print(f"ragged kernel checks: ok ({time.perf_counter() - t0:.1f} s)")
    phase_done(3, "ragged kernels", tp)

    idx_mods = (isax, dstree, vafile)
    baselines = (graph, imi, qalsh, srs)
    tp = t0 = time.perf_counter()
    phase_small(torch, S, G, idx_mods, randomwalk, queries)
    phase_small_wide(torch, S, G, isax, baselines, randomwalk, queries)
    print(f"small input, card vs CPU: ok ({time.perf_counter() - t0:.1f} s)")
    phase_done(4, "small input", tp)

    n_series, k = args.n_series, 100
    tp = t0 = time.perf_counter()
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
    mem_counts = dict(counts)
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
    phase_done(5, "main path", tp)

    # the out-of-core path, with its own launch counts
    tp = time.perf_counter()
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
    phase_done(6, "out-of-core path", tp)

    # the vector baselines on the main path's data, with their own counts
    tp = time.perf_counter()
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    base_table, base_builds, held = phase_baselines(
        torch, G, baselines, data, q, truth, k,
        PathInputs(torch, ops, ref, wrappers))
    base_counts = {name: fn.launches for name, fn in wrappers.items()}
    print(f"vector baselines at N = {n_series} "
          f"({time.perf_counter() - t0:.1f} s):")
    print_baseline_table(base_table)
    print(f"kernel inputs of the baselines path held against the plain "
          f"versions ({len(held)}): " + "; ".join(
              f"{key[0]} {key[1:]}" for key in held))
    print(f"launches on the baselines path: {base_counts}")
    missing = [name for name in ("l2", "pq_adc_batch", "lex_select")
               if base_counts[name] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the baselines "
                             f"path: {missing}")
    phase_done(7, "vector baselines", tp)

    # the sharded engine on the main path's data, with its own counts,
    # then streaming ingest on its engines, with its own
    tp = time.perf_counter()
    eng_root = root / "engine"
    shutil.rmtree(eng_root, ignore_errors=True)
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    pq_map = next(r["map"] for r in ooc_table
                  if (r["codec"], r["guarantee"]) == ("pq", "eps=1+share"))
    engines = None
    try:
        eng_table, eng_builds, held, engines = phase_engine(
            torch, S, G, ref, data, q, truth, k, dist64, pq_map, eng_root,
            PathInputs(torch, ops, ref, wrappers))
        eng_counts = {name: fn.launches for name, fn in wrappers.items()}
        print(f"sharded engine, {ENGINE_SHARDS} DSTree shards at N = "
              f"{n_series} ({time.perf_counter() - t0:.1f} s; builds "
              + ", ".join(f"{n} {s:.1f} s" for n, s in eng_builds.items())
              + "):")
        print_engine_table(eng_table)
        print(f"kernel inputs of the engine path held against the plain "
              f"versions ({len(held)}): " + "; ".join(
                  f"{key[0]} {key[1:]}" for key in held))
        print(f"launches on the engine path: {eng_counts}")
        missing = [name for name, c in eng_counts.items()
                   if c == 0 and name != "paa"]
        if missing:
            raise AssertionError(f"kernels not launched on the engine path: "
                                 f"{missing}")
        phase_done(8, "sharded engine", tp)

        for fn in wrappers.values():
            fn.launches = 0
        tp = t0 = time.perf_counter()
        before = {(r["mode"], r["guarantee"]): r["ms"] for r in eng_table}
        ing_table, ing_times, ing_held, live = phase_ingest(
            torch, S, G, ref, data, data_t, q, truth, k, engines, before,
            PathInputs(torch, ops, ref, wrappers))
        ing_counts = {name: fn.launches for name, fn in wrappers.items()}
        ing_s = phase_done(9, "streaming ingest", tp)

        for fn in wrappers.values():
            fn.launches = 0
        tp = t0 = time.perf_counter()
        srv_table, srv_info, srv_held = phase_serving(
            torch, S, G, data_t, q, truth, k, engines, live,
            PathInputs(torch, ops, ref, wrappers))
        srv_counts = {name: fn.launches for name, fn in wrappers.items()}
        srv_s = phase_done(10, "serving front", tp)
        ins_rate = ing_times["inserted"] / max(ing_times["insert_s"], 1e-9)
        del_rate = ing_times["deleted"] / max(ing_times["delete_s"], 1e-9)
        comp = ing_times["compact_s"]
        print(f"streaming ingest on the engine's shards "
              f"({ing_s:.1f} s): inserts {ins_rate:.0f} rows/s,"
              f" deletes {del_rate:.0f} rows/s, compaction "
              f"{sum(comp) / len(comp):.2f} s each ({min(comp):.2f}-"
              f"{max(comp):.2f}), tombstone masks {ing_times['mask_ms']:.1f} ms, "
              f"snapshot {ing_times['snapshot_ms']:.1f} ms, daemon "
              f"{ing_times['daemon_s']:.2f} s, rebuild {ing_times['rebuild_s']:.1f}"
              " s:")
        print_ingest_table(ing_table)
        print(f"kernel inputs of the ingest path held against the plain "
              f"versions ({len(ing_held)}): " + "; ".join(
                  f"{key[0]} {key[1:]}" for key in ing_held))
        print(f"launches on the ingest path: {ing_counts}")
        missing = [name for name, c in ing_counts.items()
                   if c == 0 and name != "paa"]
        if missing:
            raise AssertionError(f"kernels not launched on the ingest path: "
                                 f"{missing}")

        print(f"serving front on the ingest phase's engines ({srv_s:.1f} s; "
              f"F {srv_info['f_ms']:.1f} ms, R0 {srv_info['r0']:.3f} requests/s,"
              f" max batch {SERVE_BATCH}; latencies from the port's Histogram, "
              "numpy's quantile (method lower) of the same values beside):")
        print_serving_table(srv_table)
        print(f"kernel inputs of the serving path held against the plain "
              f"versions ({len(srv_held)}): " + "; ".join(
                  f"{key[0]} {key[1:]}" for key in srv_held))
        print(f"launches on the serving path: {srv_counts}")
        missing = [name for name in ("box_mindist", "coop_score_select",
                                     "lex_select", "pq_adc_select")
                   if srv_counts[name] == 0]
        if missing:
            raise AssertionError(f"kernels not launched on the serving path: "
                                 f"{missing}")
        print(json.dumps({"serving": {
            "f_ms": srv_info["f_ms"], "r0_rps": srv_info["r0"],
            "points": [{key: r[key] for key in (
                "point", "engine", "offered", "answered", "rejected", "shed",
                "rps", "p50", "p99", "np_p50", "np_p99", "degraded", "wall_s")}
                for r in srv_table],
            "fresh_ms": srv_info["fresh_ms"],
            "visible_ms": srv_info["visible_ms"],
            "retrieval_ms": srv_info["retrieval_ms"],
            "iteration_split_ms": srv_info["trace_split"]}}))

        # the LLM substrate, then retrieval-augmented serving over the
        # serving phase's resident engine, with its own counts
        for fn in wrappers.values():
            fn.launches = 0
        tp = t0 = time.perf_counter()
        model, llm_cfg, llm_info = phase_llm_model(torch)
        llm_table, llm_held = phase_llm_serving(
            torch, S, model, llm_cfg, engines["resident"], live,
            srv_info["writes"], q, srv_info["f_ms"], eng_root,
            PathInputs(torch, ops, ref, wrappers))
        llm_counts = {name: fn.launches for name, fn in wrappers.items()}
        llm_s = time.perf_counter() - t0
        del model
        print(f"LLM substrate and retrieval-augmented serving ({llm_s:.1f} s;"
              f" {llm_cfg.name} at full width and depth; latencies in ms, "
              "numpy's quantile (method lower)):")
        print_llm_table(llm_table)
        print(f"kernel inputs of the LLM path held against the plain "
              f"versions ({len(llm_held)}): " + "; ".join(
                  f"{key[0]} {key[1:]}" for key in llm_held))
        print(f"launches on the LLM path: {llm_counts}")
        missing = [name for name in ("box_mindist", "coop_score_select",
                                     "lex_select", "l2")
                   if llm_counts[name] == 0]
        if missing:
            raise AssertionError(f"kernels not launched on the LLM path: "
                                 f"{missing}")
        print(json.dumps({"llm": dict(llm_info, seconds=llm_s,
                                      serving=llm_table)}))
        phase_done(11, "LLM substrate", tp)

        # the MoE, SSM and hybrid families, then deepseek behind the static
        # front over the same engine, with their own counts
        torch.cuda.empty_cache()
        for fn in wrappers.values():
            fn.launches = 0
        tp = t0 = time.perf_counter()
        fam_info, fam_table, fam_held = phase_families(
            torch, S, engines["resident"], live, srv_info["writes"], q,
            srv_info["f_ms"], PathInputs(torch, ops, ref, wrappers))
        fam_counts = {name: fn.launches for name, fn in wrappers.items()}
        fam_s = time.perf_counter() - t0
        del live
        print(f"MoE, SSM and hybrid families ({fam_s:.1f} s; "
              + ", ".join(f"{a} {fam_info[a]['seconds']:.1f} s" for a in FAM)
              + f"; {fam_info['allocated_gb_before']:.1f} GB allocated "
              "before it"
              + "; latencies in ms, numpy's quantile (method lower)):")
        print_llm_table(fam_table)
        print(f"kernel inputs of the families path held against the plain "
              f"versions ({len(fam_held)}): " + "; ".join(
                  f"{key[0]} {key[1:]}" for key in fam_held))
        print(f"launches on the families path: {fam_counts}")
        missing = [name for name in ("box_mindist", "coop_score_select",
                                     "lex_select", "l2")
                   if fam_counts[name] == 0]
        if missing:
            raise AssertionError(f"kernels not launched on the families "
                                 f"path: {missing}")
        print(json.dumps({"families": dict(fam_info, seconds=fam_s)}))
        phase_done(12, "families", tp)
    finally:
        if engines is not None:
            engines["resident"].close()
            engines["pq"].close()
        shutil.rmtree(eng_root, ignore_errors=True)

    # the encoder-decoder family, then training, with the engines closed
    # and their own counts: no kernel of the port lies on either path
    tp = time.perf_counter()
    torch.cuda.empty_cache()
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    enc_info = phase_encdec(torch)
    enc_counts = {name: fn.launches for name, fn in wrappers.items()}
    enc_s = time.perf_counter() - t0
    print(f"encoder-decoder ({enc_s:.1f} s; {ENC_ARCH} at full width and "
          f"depth; peak {enc_info['peak_gb']:.1f} GB allocated)")
    print(f"launches on the encdec path: {enc_counts}")
    print(json.dumps({"encdec": dict(enc_info, seconds=enc_s)}))
    phase_done(13, "encoder-decoder", tp)
    tp = time.perf_counter()
    torch.cuda.empty_cache()
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    train_info = phase_train(torch, Path(build.BUILD_DIR).parent
                             / "chip_smoke_train")
    train_counts = {name: fn.launches for name, fn in wrappers.items()}
    train_s = time.perf_counter() - t0
    print(f"training ({train_s:.1f} s; "
          f"{torch.cuda.memory_allocated() / 1e9:.1f} GB still allocated "
          "by earlier phases)")
    print(f"launches on the train path: {train_counts}")
    print(json.dumps({"train": dict(train_info, seconds=train_s)}))
    phase_done(14, "training", tp)

    # the roofline phase, with its own counts: the search cell (K1, K4 and
    # lex_select through the path's recorder), then the decode cells
    tp = time.perf_counter()
    torch.cuda.empty_cache()
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    roof_info = phase_roofline(torch, S, data, data_t,
                               PathInputs(torch, ops, ref, wrappers))
    roof_counts = {name: fn.launches for name, fn in wrappers.items()}
    roof_s = time.perf_counter() - t0
    print(f"roofline ({roof_s:.1f} s: search {roof_info['search_s']:.1f} s, "
          f"{roof_info['held']} kernel inputs held against the plain "
          f"versions; total_memory {roof_info['total_memory']} bytes)")
    print(f"launches on the roofline path: {roof_counts}")
    missing = [name for name in ("box_mindist", "coop_score_select",
                                 "lex_select") if roof_counts[name] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the roofline path: "
                             f"{missing}")
    print(json.dumps({"roofline": dict(roof_info, seconds=roof_s)}))
    phase_done(15, "roofline", tp)

    # the engine across ranks, at world 1 over NCCL, with its own counts
    tp = time.perf_counter()
    torch.cuda.empty_cache()
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    mesh_info = phase_mesh(torch, S, G, data, data_t, q, truth, k, dist64,
                           root / "mesh", PathInputs(torch, ops, ref,
                                                     wrappers))
    mesh_counts = {name: fn.launches for name, fn in wrappers.items()}
    mesh_s = time.perf_counter() - t0
    col = mesh_info["collectives"]
    print(f"engine across ranks ({mesh_s:.1f} s; world "
          f"{mesh_info['world']} over {mesh_info['backend']}, mesh "
          f"{mesh_info['mesh']}; builds mesh {mesh_info['build_mesh']:.1f} s, "
          f"one card {mesh_info['build_one_card']:.1f} s; every row bit-equal "
          f"to the one-card engine; {mesh_info['held']} kernel inputs held "
          f"against the plain versions; one ng(4)+sync query: "
          f"{col['nccl_kernels']} NCCL kernels, {col['nccl_kernel_ms']:.3f} "
          f"ms, host {col['host_ops']}):")
    print_mesh_table(mesh_info["rows"])
    print(f"launches on the mesh path: {mesh_counts}")
    # K3 (l2) is not on the mesh path: the DSTree engine never calls it,
    # and brute force, the phase's comparator, runs uncounted
    missing = [name for name in ("box_mindist", "coop_score_select",
                                 "lex_select") if mesh_counts[name] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the mesh path: "
                             f"{missing}")
    print(json.dumps({"mesh": dict(mesh_info, seconds=mesh_s)}))
    phase_done(16, "engine across ranks", tp)

    # training across ranks, at world 1 over NCCL, with its own counts: no
    # kernel of the port lies on this path
    tp = time.perf_counter()
    torch.cuda.empty_cache()
    for fn in wrappers.values():
        fn.launches = 0
    tm_info = phase_train_mesh(torch)
    tm_counts = {name: fn.launches for name, fn in wrappers.items()}
    tm_s = time.perf_counter() - tp
    col = tm_info["collectives"]
    ms, ms1 = tm_info["mesh_step_s"], tm_info["one_card_step_s"]
    print(f"training across ranks ({tm_s:.1f} s; {tm_info['config']} at "
          f"full width and depth, {tm_info['params']} parameters, bf16, "
          f"{tm_info['steps']} steps of {tm_info['batch']} x "
          f"{tm_info['seq']} tokens; world {tm_info['world']} over "
          f"{tm_info['backend']}, mesh {tm_info['mesh']}; deterministic "
          f"algorithms on)")
    for i, (a, b1) in enumerate(zip(tm_info["mesh_losses"],
                                     tm_info["one_card_losses"])):
        print(f"  train mesh step {i}: loss {a!r} on the mesh "
              f"({ms[i] * 1e3:.1f} ms), {b1!r} on one card "
              f"({ms1[i] * 1e3:.1f} ms)")
    worst = max(tm_info["param_max_diff"].items(), key=lambda kv: kv[1])
    print(f"  train mesh parameters: {len(tm_info['param_max_diff'])} leaves"
          f", largest difference {worst[1]!r} ({worst[0]}); bit-equal to one"
          f" card: {tm_info['bit_equal']}")
    print(f"  train mesh collectives of one profiled step: "
          f"{col['nccl_kernels']} NCCL kernels, {col['nccl_kernel_ms']:.3f} "
          f"ms, host {col['host_ops']}")
    col1 = tm_info["one_card_collectives"]
    gap = (ms[-1] - ms1[-1]) * 1e3
    print(f"  aten calls of one profiled step, mesh / one card: outermost "
          f"{col['outer_aten_calls']} / {col1['outer_aten_calls']}, all "
          f"{col['aten_calls']} / {col1['aten_calls']}; the last step's "
          f"gap {gap:.1f} ms = {gap * 1e3 / col['outer_aten_calls']:.1f} us "
          f"an outermost mesh call")
    ps = tm_info["psum"]
    print(f"  compressed_psum over {ps['leaf']} {ps['shape']} {ps['dtype']}: "
          f"bit-equal to the local quantization at world 1, {ps['ms']:.3f} ms "
          f"(local {ps['local_ms']:.3f} ms)")
    print(f"launches on the train mesh path: {tm_counts}")
    print(json.dumps({"train_mesh": dict(tm_info, seconds=tm_s)}))
    phase_done(17, "training across ranks", tp)

    # the dry run at the production meshes: host work on meta tensors over
    # a dry world, in a subprocess; no kernel lies on this path
    tp = time.perf_counter()
    dry = phase_dry_run()
    for name, rep in dry.items():
        print(f"dry run {name} on {rep['mesh']} ({rep['world']} ranks): "
              f"status {rep['status']}, {rep['n_collectives']} collectives "
              f"{rep['wire_bytes_by_kind']}, live {rep['live_gib']:.2f} GiB "
              f"a device, fits {rep['fits_hbm']}, bottleneck "
              f"{rep['bottleneck']}, {rep['seconds']:.1f} s on the host")
    dry_s = time.perf_counter() - tp
    print(json.dumps({"dry_run": dict(dry, seconds=dry_s)}))
    phase_done(18, "dry run at the production meshes", tp)

    tp = time.perf_counter()
    rows = kernel_rows(torch, ops, ref, build, data_t, q_t, built["isax2+"],
                       built["va+file"], k, counts, pq_in)
    for r in rows:
        r["launches_by_path"] = {
            "in_memory": mem_counts[r["name"]],
            "out_of_core": ooc_counts[r["name"]],
            "baselines": base_counts[r["name"]],
            "engine": eng_counts[r["name"]],
            "ingest": ing_counts[r["name"]],
            "serving": srv_counts[r["name"]],
            "llm": llm_counts[r["name"]],
            "families": fam_counts[r["name"]],
            "encdec": enc_counts[r["name"]],
            "train": train_counts[r["name"]],
            "roofline": roof_counts[r["name"]],
            "mesh": mesh_counts[r["name"]],
            "train_mesh": tm_counts[r["name"]]}
    shapes = shape_rows(torch, ops, ref, data_t, q_t)
    for r in shapes:
        print(f"  {r['name']} at {r['shape']}: {r['ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    print(json.dumps({"kernel_shapes": shapes}))
    phase_done(19, "kernels at the main path's shapes", tp)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
