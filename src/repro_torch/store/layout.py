"""On-disk index format (v2) and the LeafStore handle.

The port's reader and writer of ``src/repro/store/layout.py``'s format;
a store written by either package opens in the other. A saved index is
a directory:

    meta.json      format version, the FrozenIndex's static fields, the
                   array shapes, the raw rows' dtype and the leaf
                   payload's ``codec``
    data.bin       [npad, payload_cols] leaf payload rows in the codec's
                   encoding, leaf-contiguous (row i of leaf l lives at
                   offsets[l] + i), so a leaf visit is one sequential read
    exact.bin      (codec "pq" only) [npad, series_len] raw rows in the
                   index's dtype, same layout; read by the exact re-rank
                   and by resident="full"
    sidecar.npz    box_lo / box_hi / weights / offsets / ids, the distance
                   histogram's edges / cdf, ``row_norms`` (squared norms
                   of the decoded rows), and for codec "pq" the codebook
                   (pq_centroids [m, K, dsub], pq_rotation [d, d])

Codecs: "f32" stores the index's own rows verbatim (a bfloat16 index
stores bfloat16); "bf16" stores the rows rounded to bfloat16 (round to
nearest even, as the reference's cast does), so resident="full" returns
the bfloat16 image of the index; "pq" stores one uint8 code per
subspace (K = 256) from a codebook trained at save time. numpy has no
bfloat16: bfloat16 payloads are written and read as their uint16 bits
and viewed as ``torch.bfloat16``.

Only format v2 is read. A v1 store (the reference reads it with a
deprecation warning) raises here: re-save it with the reference.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Union

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.core.histogram import DistanceHistogram
from repro_torch.core.index import FrozenIndex
from repro_torch.core.summaries.pq import (PQCodebook, Seed, pq_encode,
                                           pq_train)
from repro_torch.kernels import ops

FORMAT_VERSION = 2
CODECS = ("f32", "bf16", "pq")
META_NAME = "meta.json"
DATA_NAME = "data.bin"
EXACT_NAME = "exact.bin"
SIDECAR_NAME = "sidecar.npz"
PQ_K = 256  # one uint8 code per subspace

# dtype names of meta.json -> the tensor dtype, and the numpy dtype of the
# bytes on disk (bfloat16 as its uint16 bits)
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "uint8": torch.uint8}
DISK_DTYPES = {"float32": np.float32, "bfloat16": np.uint16,
               "uint8": np.uint8}
DTYPE_NAMES = {v: k for k, v in TORCH_DTYPES.items()}


def to_host(t: torch.Tensor) -> np.ndarray:
    """A tensor's bytes as a numpy array (bfloat16 as uint16 bits)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def to_tensor(a: np.ndarray, name: str, device) -> torch.Tensor:
    """Disk bytes of dtype ``name`` (meta.json's spelling) as a tensor on
    ``device``."""
    a = np.ascontiguousarray(a)
    if name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _default_pq_m(series_len: int) -> int:
    for m in (16, 8, 4, 2, 1):
        if series_len % m == 0:
            return m
    return 1


def save_index(index: FrozenIndex, directory: str, *, codec: str = "f32",
               pq_m: Optional[int] = None, pq_iters: int = 6,
               pq_train_rows: int = 8192, pq_seed: Seed = 0) -> str:
    """Persist ``index`` under ``directory`` (created if missing).

    ``codec`` selects data.bin's encoding (module docstring). For "pq",
    ``pq_m`` sub-quantizers (must divide series_len; default the largest
    of 16/8/4/2 that does) are trained with ``pq_iters`` k-means
    iterations and the generator ``pq_seed`` on at most
    ``pq_train_rows`` rows, sampled as the reference samples them
    (``np.random.default_rng(0)``); the codebook trains and encodes on
    the index's device."""
    if codec not in CODECS:
        raise ValueError(f"codec must be one of {CODECS}, got {codec!r}")
    os.makedirs(directory, exist_ok=True)
    data = index.data
    dtype_name = DTYPE_NAMES[data.dtype]
    meta = {
        "format_version": FORMAT_VERSION,
        "codec": codec,
        "kind": index.kind,
        "summary": index.summary,
        "n_summary": index.n_summary,
        "max_leaf": index.max_leaf,
        "n_total": index.n_total,
        "series_len": index.series_len,
        "npad": int(data.shape[0]),
        "n_leaves": int(index.num_leaves),
        "n_dims": int(index.box_lo.shape[1]),
        "data_dtype": dtype_name,
    }
    sidecar = dict(
        box_lo=to_host(index.box_lo), box_hi=to_host(index.box_hi),
        weights=to_host(index.weights), offsets=to_host(index.offsets),
        ids=to_host(index.ids), hist_edges=to_host(index.hist.edges),
        hist_cdf=to_host(index.hist.cdf))
    # squared norms of the decoded rows, which the reloaded index and the
    # out-of-core gathers use: bf16 decodes to the bfloat16 image
    if codec == "bf16":
        payload = data.to(torch.bfloat16)
        sidecar["row_norms"] = to_host(ops.row_sq_norms(payload))
    else:
        payload = data
        sidecar["row_norms"] = to_host(index.row_norms)
    if codec == "pq":
        m = _default_pq_m(index.series_len) if pq_m is None else int(pq_m)
        if index.series_len % m:
            raise ValueError(
                f"pq_m={m} must divide series_len={index.series_len}")
        real = np.flatnonzero(sidecar["ids"] >= 0)
        if real.shape[0] > pq_train_rows:
            real = real[np.random.default_rng(0).choice(
                real.shape[0], pq_train_rows, replace=False)]
        rows = data[torch.as_tensor(real, device=data.device)].float()
        cb = pq_train(pq_seed, rows, m, k=PQ_K, iters=pq_iters)
        payload = pq_encode(cb, data).to(torch.uint8)
        meta["pq_m"] = m
        sidecar["pq_centroids"] = to_host(cb.centroids.float())
        sidecar["pq_rotation"] = to_host(cb.rotation.float())
        to_host(data).tofile(os.path.join(directory, EXACT_NAME))
    meta["payload_dtype"] = DTYPE_NAMES[payload.dtype]
    meta["payload_cols"] = int(payload.shape[1])
    to_host(payload).tofile(os.path.join(directory, DATA_NAME))
    np.savez(os.path.join(directory, SIDECAR_NAME), **sidecar)
    with open(os.path.join(directory, META_NAME), "w") as f:
        json.dump(meta, f, indent=1)
    return directory


@dataclasses.dataclass
class LeafStore:
    """Out-of-core residency: filter state on the device, payload on disk.

    ``resident`` is a FrozenIndex whose ``data`` is an empty [0, n]
    placeholder: everything the filter stage and the id lookup need is on
    the device, and the encoded leaf payload is reachable only through
    ``mmap`` (or a DeviceLeafCache over it); for codec "pq" the raw rows
    also through ``exact_mmap`` (re-rank reads only). The memmaps hold
    disk dtypes: bfloat16 rows as uint16 bits."""

    directory: str
    resident: FrozenIndex
    mmap: np.memmap          # [npad, payload_cols], leaf-contiguous
    meta: dict
    offsets_h: np.ndarray    # [L+1] int64 host copy for disk reads
    codec: str = "f32"
    exact_mmap: Optional[np.memmap] = None   # pq only: raw rows
    codebook: Optional[PQCodebook] = None    # pq only: device tensors

    @property
    def device(self) -> torch.device:
        return self.resident.device

    @property
    def num_leaves(self) -> int:
        return self.resident.num_leaves

    @property
    def max_leaf(self) -> int:
        return self.resident.max_leaf

    @property
    def series_len(self) -> int:
        return self.resident.series_len

    @property
    def payload_dtype(self) -> torch.dtype:
        """Tensor dtype of the encoded payload rows (what cache slots
        hold): float32, bfloat16, or uint8 for pq."""
        return TORCH_DTYPES[self.meta["payload_dtype"]]

    @property
    def payload_cols(self) -> int:
        """Columns per encoded payload row (series_len, or pq_m)."""
        return self.mmap.shape[1]

    @property
    def dataset_nbytes(self) -> int:
        """Size of the raw collection (rows in the index dtype), not of
        the encoded payload, so %-data stays comparable across codecs."""
        itemsize = np.dtype(DISK_DTYPES[self.meta["data_dtype"]]).itemsize
        return int(self.mmap.shape[0]) * self.series_len * itemsize

    def leaf_size(self, leaf: int) -> int:
        return int(self.offsets_h[leaf + 1] - self.offsets_h[leaf])

    def read_leaf(self, leaf: int, out: np.ndarray = None) -> np.ndarray:
        """One leaf's encoded rows, padded to [max_leaf, payload_cols]:
        one contiguous range of data.bin. Rows of ``out`` past the leaf
        are zeroed, so a reused buffer never leaks a larger leaf's rows."""
        lo = int(self.offsets_h[leaf])
        hi = int(self.offsets_h[leaf + 1])
        if out is None:
            out = np.zeros((self.max_leaf, self.payload_cols),
                           self.mmap.dtype)
        else:
            out[hi - lo:] = 0
        out[: hi - lo] = self.mmap[lo:hi]
        return out

    def read_rows_exact(self, positions: np.ndarray) -> np.ndarray:
        """Raw rows of exact.bin by padded row position (disk dtype): the
        pq re-rank's small random reads."""
        return np.asarray(self.exact_mmap[np.asarray(positions, np.int64)])

    def leaf_nbytes(self, leaf: int) -> int:
        return self.leaf_size(leaf) * self.payload_cols \
            * self.mmap.dtype.itemsize


def load_index(directory: str, resident: str = "full",
               device=device_mod.DEFAULT) -> Union[FrozenIndex, LeafStore]:
    """Open a saved index on ``device``. resident="full" -> FrozenIndex
    (the stored rows for codec f32 and pq, the bfloat16 image for bf16);
    resident="summaries" -> LeafStore (the payload stays on disk)."""
    dev = device_mod.resolve(device)
    if resident not in ("full", "summaries"):
        raise ValueError("resident must be 'full' or 'summaries', "
                         f"got {resident!r}")
    with open(os.path.join(directory, META_NAME)) as f:
        meta = json.load(f)
    ver = meta["format_version"]
    if ver != FORMAT_VERSION:
        raise ValueError(
            f"store format {ver} at {directory!r}: this reader opens "
            f"format {FORMAT_VERSION} only (a v1 store is re-saved with "
            "the reference's save_index)")
    codec = meta["codec"]
    side = np.load(os.path.join(directory, SIDECAR_NAME))
    dtype_name = meta["data_dtype"]
    npad, n = meta["npad"], meta["series_len"]
    mmap = np.memmap(os.path.join(directory, DATA_NAME),
                     dtype=DISK_DTYPES[meta["payload_dtype"]], mode="r",
                     shape=(npad, meta["payload_cols"]))
    exact_mmap = codebook = None
    if codec == "pq":
        exact_mmap = np.memmap(os.path.join(directory, EXACT_NAME),
                               dtype=DISK_DTYPES[dtype_name], mode="r",
                               shape=(npad, n))
        codebook = PQCodebook(
            centroids=to_tensor(side["pq_centroids"], "float32", dev),
            rotation=to_tensor(side["pq_rotation"], "float32", dev))
    if resident == "full":
        src = exact_mmap if codec == "pq" else mmap
        data = to_tensor(np.array(src), meta["payload_dtype"]
                         if codec != "pq" else dtype_name, dev)
    else:
        data = torch.zeros((0, n), dtype=TORCH_DTYPES[dtype_name],
                           device=dev)
    index = FrozenIndex(
        box_lo=to_tensor(side["box_lo"], "float32", dev),
        box_hi=to_tensor(side["box_hi"], "float32", dev),
        weights=to_tensor(side["weights"], "float32", dev),
        offsets=torch.as_tensor(side["offsets"], dtype=torch.int32,
                                device=dev),
        data=data,
        ids=torch.as_tensor(side["ids"], dtype=torch.int32, device=dev),
        row_norms=to_tensor(side["row_norms"], "float32", dev),
        hist=DistanceHistogram(
            edges=to_tensor(side["hist_edges"], "float32", dev),
            cdf=to_tensor(side["hist_cdf"], "float32", dev)),
        kind=meta["kind"], summary=meta["summary"],
        n_summary=meta["n_summary"], max_leaf=meta["max_leaf"],
        n_total=meta["n_total"], series_len=n)
    if resident == "full":
        return index
    return LeafStore(directory=directory, resident=index, mmap=mmap,
                     meta=meta,
                     offsets_h=np.asarray(side["offsets"], np.int64),
                     codec=codec, exact_mmap=exact_mmap, codebook=codebook)
