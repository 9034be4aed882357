"""FrozenIndex: the searchable artifact shared by iSAX2+, DSTree, VA+file.

Every data-series index of the paper reduces, once built, to the same
structure: per-leaf summary-space boxes with per-dim weights (the lower
bound is a weighted box distance), leaf extents over a leaf-contiguous
permutation of the raw data, and the distance histogram for r_delta.
Trees differ only in how boxes and extents are chosen at build time;
search (core/search.py) is the same for all of them.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.kernels import ops

from .histogram import DistanceHistogram
from .summaries import dft as dft_mod
from .summaries import eapca as eapca_mod
from .summaries import paa as paa_mod

ARRAY_FIELDS = ("box_lo", "box_hi", "weights", "offsets", "data", "ids",
                "row_norms")
META_FIELDS = ("kind", "summary", "n_summary", "max_leaf", "n_total",
               "series_len")


@dataclasses.dataclass(frozen=True)
class FrozenIndex:
    box_lo: torch.Tensor     # [L, D] f32 summary-space box lower corners
    box_hi: torch.Tensor     # [L, D] f32
    weights: torch.Tensor    # [D] f32 per-dim lower-bound weights
    offsets: torch.Tensor    # [L+1] int32 leaf extents into the rows
    data: torch.Tensor       # [Npad, n] raw series, leaf-contiguous
    ids: torch.Tensor        # [Npad] int32 original ids (-1 = padding)
    row_norms: torch.Tensor  # [Npad] f32 squared norms of ``data``
    hist: DistanceHistogram
    kind: str
    summary: str
    n_summary: int
    max_leaf: int
    n_total: int
    series_len: int

    @property
    def num_leaves(self) -> int:
        return self.box_lo.shape[0]

    @property
    def device(self) -> torch.device:
        return self.data.device

    def summarize_queries(self, q: torch.Tensor) -> torch.Tensor:
        """This index's summary of a query batch [B, n]."""
        if self.summary == "paa":
            return paa_mod.transform(q, self.n_summary)
        if self.summary == "eapca":
            return eapca_mod.transform(q, self.n_summary)
        if self.summary == "dft":
            return dft_mod.transform(q, self.n_summary)
        raise ValueError(self.summary)

    # --- the out-of-core tier (repro_torch.store)
    def save(self, directory: str, **kw) -> str:
        """Persist as a v2 store (leaf-contiguous data.bin + sidecar);
        ``codec`` in {"f32", "bf16", "pq"} selects the leaf payload's
        encoding, pq_* tune the codebook (store.layout.save_index)."""
        from repro_torch.store import layout

        return layout.save_index(self, directory, **kw)

    @classmethod
    def load(cls, directory: str, resident: str = "full",
             device=device_mod.DEFAULT):
        """resident="full" -> FrozenIndex; resident="summaries" ->
        store.LeafStore, whose rows stay on disk (search them with
        core.search.search_ooc)."""
        from repro_torch.store import layout

        return layout.load_index(directory, resident=resident,
                                 device=device)


def freeze_from_leaves(
    data: torch.Tensor,          # [N, n] f32, original order, on device
    leaf_members: list,          # int arrays of original row ids
    box_lo: np.ndarray,          # [L, D]
    box_hi: np.ndarray,
    weights: np.ndarray,         # [D]
    hist: DistanceHistogram,
    *,
    kind: str,
    summary: str,
    n_summary: int,
    pad_multiple: int = 8,
) -> FrozenIndex:
    """Assemble the index (f32 rows) from a host-side build, on data's
    device."""
    dev = data.device
    n, series_len = data.shape
    sizes = np.array([len(m) for m in leaf_members], np.int64)
    offsets = np.zeros(len(leaf_members) + 1, np.int64)
    offsets[1:] = np.cumsum(sizes)
    perm = np.concatenate(leaf_members) if leaf_members else \
        np.zeros(0, np.int64)
    if perm.shape[0] != n:
        raise ValueError(f"leaves hold {perm.shape[0]} rows, data {n}")
    npad = int(np.ceil(max(n, 1) / pad_multiple) * pad_multiple)
    perm_t = torch.as_tensor(perm, dtype=torch.long, device=dev)
    pdata = torch.zeros((npad, series_len), dtype=torch.float32, device=dev)
    pdata[:n] = data[perm_t].float()
    pids = torch.full((npad,), -1, dtype=torch.int32, device=dev)
    pids[:n] = perm_t.to(torch.int32)
    return FrozenIndex(
        box_lo=torch.as_tensor(box_lo, dtype=torch.float32, device=dev),
        box_hi=torch.as_tensor(box_hi, dtype=torch.float32, device=dev),
        weights=torch.as_tensor(weights, dtype=torch.float32, device=dev),
        offsets=torch.as_tensor(offsets, dtype=torch.int32, device=dev),
        data=pdata,
        ids=pids,
        row_norms=ops.row_sq_norms(pdata),
        hist=hist,
        kind=kind,
        summary=summary,
        n_summary=n_summary,
        max_leaf=int(sizes.max()) if len(sizes) else 1,
        n_total=n,
        series_len=series_len,
    )


def _tensor(a: np.ndarray, dtype, dev) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # the JAX package's bf16 payload
        bits = np.array(a).view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16).to(dev)
    return torch.tensor(a, dtype=dtype, device=dev)


def frozen_index_from_arrays(arrays: Mapping[str, np.ndarray],
                             meta: Mapping, device=device_mod.DEFAULT,
                             ) -> FrozenIndex:
    """The index held by a set of host arrays — the fields of a JAX
    ``FrozenIndex`` (``box_lo``, ``box_hi``, ``weights``, ``offsets``,
    ``data``, ``ids``, optional ``row_norms``) plus the histogram's
    ``edges`` and ``cdf`` — and its static fields ``meta`` (``kind``,
    ``summary``, ``n_summary``, ``max_leaf``, ``n_total``,
    ``series_len``), placed on ``device``."""
    dev = device_mod.resolve(device)
    data = _tensor(arrays["data"], None, dev)
    if data.dtype not in (torch.float32, torch.bfloat16):
        data = data.float()
    norms = arrays.get("row_norms")
    return FrozenIndex(
        box_lo=_tensor(arrays["box_lo"], torch.float32, dev),
        box_hi=_tensor(arrays["box_hi"], torch.float32, dev),
        weights=_tensor(arrays["weights"], torch.float32, dev),
        offsets=_tensor(arrays["offsets"], torch.int32, dev),
        data=data,
        ids=_tensor(arrays["ids"], torch.int32, dev),
        row_norms=ops.row_sq_norms(data) if norms is None
        else _tensor(norms, torch.float32, dev),
        hist=DistanceHistogram(
            edges=_tensor(arrays["edges"], torch.float32, dev),
            cdf=_tensor(arrays["cdf"], torch.float32, dev)),
        **{f: meta[f] for f in META_FIELDS},
    )


def index_device(index: FrozenIndex, device) -> torch.device:
    """Resolve ``device`` for a search and check the index lives there."""
    return device_mod.matching(index.device, device)
