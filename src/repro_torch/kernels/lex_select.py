"""``lex_select``: the exact (d, id) selection shared by K4 and K6.

Replaces the selection stage of ``src/repro/kernels/topk.py``
(``lex_min_select``, kk rounds of min-extraction in VMEM, which the TPU
kernels of K4 and K6 both run) with ``csrc/lex_select.cu``: a radix
select on a 64-bit key (the distance's bits in sign-aware order, then
the id) finds the kk-th smallest key exactly, gathers the keys below it
and sorts them: up to 1024 keys in shared memory, more as runs in shared
memory merged through a scratch in device memory.

The call is bound by bytes, and it reads the [B, R] scores once. Which
kernels read them depends on R and kk alone (:func:`plan`):

* ``lane``, R <= ``STAGE_MAX`` (the main path's B = 100, R = 25,600, the
  graph and QALSH callers, K6): one block a lane stages the lane in
  shared memory. The scores come from L2 when a score pass has just
  written them.
* ``split``, R > ``STAGE_MAX`` and kk <= ``MAX_KK`` (the search cell's
  B = 256, R = 1,001,472: 1 GB, read from HBM once, the scores of masked
  slots not at all): one block a chunk of ``CHUNK`` slots a lane. The
  first chunk's kk-th key bounds the lane's kk smallest; every other
  chunk keeps only its keys at or below that bound (~kk at the search
  cell) and of those its kk smallest; then one block a lane selects
  from its chunks' keys. The answer is the lane path's, bit for bit.
* ``lane`` with kk > ``MAX_KK`` and R > ``STAGE_MAX``: one block a lane
  reads the scores from device memory in every pass.

While a span sink is on (``obs.sink_on()``), each call counts in
``kernels.lex_select{path=split|lane}`` under the path its shape takes,
whether the kernel or (on the CPU) the plain version answers it.
"""

from __future__ import annotations

import torch

from repro_torch import obs

from . import ref

# the library's limits (lex_select_limit), checked when it first loads
STAGE_MAX = 48 * 1024   # slots a lane the lane path stages
MAX_KK = 1024           # selections sorted in shared memory
CHUNK = 16 * 1024       # slots a block of the split path stages
_limits_checked = False
_CALLS = {p: obs.REGISTRY.counter("kernels.lex_select", path=p)
          for p in ("split", "lane")}


def plan(r: int, kk: int) -> tuple:
    """The path of a call over r slots a lane selecting kk, and the
    chunks a lane it cuts them into: ("split", ceil(r / CHUNK)) when a
    lane is too long to stage and the selection sorts in shared memory,
    else ("lane", 1)."""
    if r > STAGE_MAX and kk <= MAX_KK:
        return "split", -(-r // CHUNK)
    return "lane", 1


def scratch_keys(b: int, r: int, kk: int) -> int:
    """The 64-bit words a call over [b, r] scores needs as its scratch:
    on the split path the chunks' keys [b, chunks, kk] and a word a lane
    for its bound; two [b, kk] buffers for the sort's merge passes when
    kk > MAX_KK; else none."""
    path, chunks = plan(r, kk)
    if path == "split":
        return b * chunks * kk + b
    return 2 * b * kk if kk > MAX_KK else 0


def _library():
    """The lex_select library, its limits checked once against
    STAGE_MAX, MAX_KK and CHUNK."""
    global _limits_checked
    from . import build

    lib = build.library("lex_select")
    if not _limits_checked:
        got = tuple(lib.lex_select_limit(i) for i in range(3))
        if got != (STAGE_MAX, MAX_KK, CHUNK):
            raise RuntimeError(f"lex_select's library plans by {got}, the "
                               f"wrapper by {(STAGE_MAX, MAX_KK, CHUNK)}")
        _limits_checked = True
    return lib


def lex_select(d: torch.Tensor, ids: torch.Tensor, kk: int) -> tuple:
    """Per lane of the scores d [B, R] f32 against the shared ids [R]
    int32, the kk lexicographically smallest (d, id) pairs, sorted:
    d [B, kk] f32, ids [B, kk] int32. A slot with a negative id counts
    as (inf, id), so masked slots come out as (inf, -1). Precondition:
    real ids are distinct. A CPU tensor takes the plain version; CUDA
    tensors launch the kernel, any 1 <= kk <= R."""
    if kk > d.shape[1]:
        raise ValueError(f"kk={kk} exceeds the pool of {d.shape[1]} rows")
    if kk < 1:
        raise ValueError(f"lex_select needs kk >= 1, got {kk}")
    b, r = d.shape
    if obs.sink_on():
        _CALLS[plan(r, kk)[0]].inc()
    if d.device.type == "cpu":
        return ref.ref_lex_select(d, ids, kk)
    from . import build

    build.require(d, (torch.float32,), "lex_select scores", 2)
    build.require(ids, (torch.int32,), "lex_select ids", 1)
    if ids.shape[0] != r:
        raise ValueError(f"lex_select shapes disagree: scores {d.shape}, "
                         f"ids {ids.shape}")
    out_d = torch.empty((b, kk), dtype=torch.float32, device=d.device)
    out_i = torch.empty((b, kk), dtype=torch.int32, device=d.device)
    lib = _library()
    n = scratch_keys(b, r, kk)
    scratch = torch.empty(n, dtype=torch.int64, device=d.device) if n \
        else None
    with torch.cuda.device(d.device):
        build.check(lib.lex_select_f32(
            d.data_ptr(), ids.data_ptr(), out_d.data_ptr(), out_i.data_ptr(),
            b, r, kk, None if scratch is None else scratch.data_ptr(),
            build.stream(d)), "lex_select")
    build.count_launch(lex_select)
    return out_d, out_i


lex_select.launches = 0
