"""K4 ``coop_score_select``: cooperative score, then exact select.

Replaces ``src/repro/kernels/topk.py`` (``coop_score_select_pallas`` /
``_coop_topk_kernel`` with ``lex_min_select``) with two kernels. The
score pass (``csrc/topk.cu``) is K3's register-tiled f32 GEMM
(``csrc/gemm_tile.cuh``) with the cached row norms passed in: it writes
each lane's distance to each pooled slot it keeps into a scratch matrix
[B, R], bound by f32 operations. :func:`lex_select.lex_select` then
keeps each lane's kk smallest (d, id) pairs; at the main path's
B = 100, R = 25,600 the matrix is 10 MB and stays in L2 between the two.

The pass does only the work the answers use. With a row ``index``, slot
r's row is ``rows[index[r]]``: it reads the index's rows (or a device
cache's slots) where they lie, and no pool is gathered first (1 GB an
iteration at the search cell's B = 256, R = 1,001,472). A block of 128
slots whose ids are all negative (same-iteration copies of a leaf, empty
slots) returns at once, writing nothing: the selection never reads the
score of a slot with a negative id. The lane tile is 104 or 128 lanes,
whichever pads the batch less (:func:`lane_tile`): 4% at B = 100, none
at B = 256. Every kept slot's score is bit-identical to the dense pass's.
The tile is a kernel argument, so the pass stays the one kernel
``gemm::l2_tile_kernel<float, true>``, the name the benchmark's K4
metrics find it by.

While a span sink is on, the search loop adds each launch's tiles, row
tiles x lane tiles, to ``kernels.k4_tiles{state=scored|skipped}``
(:func:`count_tiles`), summed on the device.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch import obs

from . import ref
from .lex_select import lex_select

# the pass's tile, which count_tiles counts by; the library exports its
# own (coop_score_tile), checked against these when it is first loaded
ROW_TILE = 128          # slots a block of the score pass holds
LANE_TILES = (128, 104)  # lanes a block may hold; 128 wins a tie
_tile_checked = False
_TILES_SCORED = obs.REGISTRY.counter("kernels.k4_tiles", state="scored")
_TILES_SKIPPED = obs.REGISTRY.counter("kernels.k4_tiles", state="skipped")


def lane_tile(b: int) -> int:
    """The lanes a block of the score pass holds at a batch of b: the
    tile that pads the batch to the fewest lanes."""
    return min(LANE_TILES, key=lambda t: -(-b // t) * t)


def count_tiles(kept: torch.Tensor, b: int) -> None:
    """Add the score pass's tiles over launches of b lanes to
    ``kernels.k4_tiles``: kept [F, R] bool, each launch's slots whose id
    is not negative. A row tile with none is skipped for every lane
    tile. Counted on kept's device, read nowhere here."""
    f, r = kept.shape
    pad = -r % ROW_TILE
    if pad:
        kept = torch.cat([kept, kept.new_zeros((f, pad))], 1)
    lt = -(-b // lane_tile(b))
    scored = kept.view(f, -1, ROW_TILE).any(2).sum() * lt
    _TILES_SCORED.inc(scored)
    _TILES_SKIPPED.inc(f * (r + pad) // ROW_TILE * lt - scored)


def _library():
    """The topk library, its tile checked once against ROW_TILE and
    LANE_TILES."""
    global _tile_checked
    from . import build

    lib = build.library("topk")
    if not _tile_checked:
        got = tuple(lib.coop_score_tile(i) for i in range(3))
        if got != (ROW_TILE,) + LANE_TILES:
            raise RuntimeError(f"topk: the library's tile {got} is not "
                               f"{(ROW_TILE,) + LANE_TILES}, which "
                               "count_tiles counts by")
        _tile_checked = True
    return lib


def score_pass(q: torch.Tensor, rows: torch.Tensor, row_norms: torch.Tensor,
               ids: torch.Tensor,
               index: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The scores [B, R] f32 of every lane against every slot r (the row
    ``rows[index[r]]``, or ``rows[r]`` without an index): K4's first
    pass. On the card a row tile of 128 slots whose ids are all negative
    is left unwritten; on the CPU, the plain scores of every slot."""
    if q.device.type == "cpu":
        return ref.ref_coop_scores(
            q, rows if index is None else rows[index], row_norms)
    from . import build

    build.require(rows, (torch.float32, torch.bfloat16),
                  "coop_score_select rows", 2)
    qf = q.float().contiguous()
    build.require(qf, (torch.float32,), "coop_score_select q", 2)
    build.require(row_norms, (torch.float32,), "coop_score_select norms", 1)
    build.require(ids, (torch.int32,), "coop_score_select ids", 1)
    if index is not None:
        build.require(index, (torch.int64,), "coop_score_select index", 1)
    b, n = qf.shape
    r = rows.shape[0] if index is None else index.shape[0]
    if rows.shape[1] != n or row_norms.shape[0] != r or ids.shape[0] != r:
        raise ValueError(f"coop_score_select shapes disagree: q {q.shape}, "
                         f"rows {rows.shape}, index "
                         f"{None if index is None else index.shape}, "
                         f"norms {row_norms.shape}, ids {ids.shape}")
    scores = torch.empty((b, r), dtype=torch.float32, device=q.device)
    lib = _library()
    fn = lib.coop_score_f32 if rows.dtype == torch.float32 \
        else lib.coop_score_bf16
    with torch.cuda.device(q.device):
        build.check(fn(qf.data_ptr(), rows.data_ptr(),
                       None if index is None else index.data_ptr(),
                       row_norms.data_ptr(), ids.data_ptr(),
                       scores.data_ptr(), b, r, n, lane_tile(b),
                       build.stream(q)), "coop_score_select")
    return scores


def coop_score_select(q: torch.Tensor, rows: torch.Tensor,
                      row_norms: torch.Tensor, ids: torch.Tensor,
                      kk: int, index: Optional[torch.Tensor] = None
                      ) -> tuple:
    """Per lane, the kk lexicographically smallest (d, id) pairs over the
    pooled slots, sorted: d [B, kk] f32, ids [B, kk] int32. Slot r holds
    the row ``rows[index[r]]`` (int64 index [R]), or ``rows[r]`` without
    an index; ``row_norms`` and ``ids`` are the slots' [R]. Masked slots
    carry id -1 and score (inf, -1). Precondition: real ids are distinct
    in the pool. A CPU tensor takes the plain version; CUDA tensors
    launch the kernels, any kk up to the pool."""
    r = rows.shape[0] if index is None else index.shape[0]
    if kk > r:
        raise ValueError(f"kk={kk} exceeds the pool of {r} rows")
    if q.device.type == "cpu":
        return ref.ref_coop_score_select(
            q, rows if index is None else rows[index], row_norms, ids, kk)
    from . import build

    scores = score_pass(q, rows, row_norms, ids, index)
    build.count_launch(coop_score_select)
    return lex_select(scores, ids, kk)


coop_score_select.launches = 0
