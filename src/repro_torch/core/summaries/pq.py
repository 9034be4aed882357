"""Product quantization (Jegou et al.) and OPQ's rotation (Ge et al.).

Counterpart of ``src/repro/core/summaries/pq.py``: k-means, PQ training
and encoding, and the asymmetric-distance (ADC) tables. Distances go
through ``ops.l2`` (the K3 kernel on the card) and the ADC scan through
``ops.pq_adc`` (K5). The reference draws its samples from ``jax.random``;
here they come from a ``torch.Generator`` (or an integer seed for one),
so a trained codebook differs from the reference's, and a test that
needs the same codes hands both packages the same codebook.
"""

from __future__ import annotations

from typing import NamedTuple, Union

import torch

from repro_torch.kernels import ops

Seed = Union[int, torch.Generator]

# rows encoded at once, which bounds the [rows, K] distance block
_ENCODE_CHUNK = 1 << 18


def _generator(seed: Seed) -> torch.Generator:
    if isinstance(seed, torch.Generator):
        return seed
    return torch.Generator().manual_seed(int(seed))


def kmeans(seed: Seed, x: torch.Tensor, k: int, iters: int = 25
           ) -> torch.Tensor:
    """Lloyd's k-means: x [N, d] -> centroids [k, d] f32, on x's device.
    Starts from k distinct random rows; an empty cluster is re-seeded on
    a random row each iteration."""
    g = _generator(seed)
    n = x.shape[0]
    xf = x.float()
    init = torch.randperm(n, generator=g, device=g.device)[:k]
    cent = xf[init.to(x.device)]
    for _ in range(iters):
        assign = torch.argmin(ops.l2(xf, cent), dim=1)
        one = torch.nn.functional.one_hot(assign, k).float()  # [N, k]
        counts = one.sum(0)
        newc = (one.T @ xf) / torch.clamp_min(counts[:, None], 1.0)
        rnd = torch.randint(0, n, (k,), generator=g, device=g.device)
        cent = torch.where(counts[:, None] > 0, newc, xf[rnd.to(x.device)])
    return cent


class PQCodebook(NamedTuple):
    centroids: torch.Tensor  # [m, K, d_sub] f32
    rotation: torch.Tensor   # [d, d] f32 (identity for plain PQ)


def pq_train(seed: Seed, x: torch.Tensor, m: int, k: int = 256,
             iters: int = 20, opq_iters: int = 0) -> PQCodebook:
    """Train PQ (opq_iters=0) or OPQ (alternating rotation/codebooks) on
    x [N, d], d divisible by m."""
    g = _generator(seed)
    n, d = x.shape
    if d % m:
        raise ValueError(f"pq_train: m={m} must divide d={d}")
    dsub = d // m
    xf = x.float()
    rot = torch.eye(d, dtype=torch.float32, device=x.device)

    def train_codebooks(xr):
        return torch.stack([
            kmeans(g, xr[:, j * dsub:(j + 1) * dsub], k, iters)
            for j in range(m)])  # [m, K, dsub]

    cents = train_codebooks(xf @ rot)
    for _ in range(opq_iters):
        codes = pq_encode(PQCodebook(cents, rot), x)
        recon = pq_reconstruct(PQCodebook(cents, torch.eye(
            d, dtype=torch.float32, device=x.device)), codes)
        # Procrustes: R = argmin ||X R - recon||_F  =>  R = U V^T
        u, _, vt = torch.linalg.svd(xf.T @ recon, full_matrices=False)
        rot = u @ vt
        cents = train_codebooks(xf @ rot)
    return PQCodebook(cents, rot)


def pq_encode(cb: PQCodebook, x: torch.Tensor) -> torch.Tensor:
    """[N, d] -> [N, m] int32 codes: per subspace, the nearest centroid
    (the first of equal ones)."""
    m, _, dsub = cb.centroids.shape
    out = torch.empty((x.shape[0], m), dtype=torch.int32, device=x.device)
    for lo in range(0, x.shape[0], _ENCODE_CHUNK):
        xf = x[lo:lo + _ENCODE_CHUNK].float() @ cb.rotation
        for j in range(m):
            sub = xf[:, j * dsub:(j + 1) * dsub]
            out[lo:lo + _ENCODE_CHUNK, j] = torch.argmin(
                ops.l2(sub, cb.centroids[j]), dim=1).to(torch.int32)
    return out


def pq_reconstruct(cb: PQCodebook, codes: torch.Tensor) -> torch.Tensor:
    """Codes [N, m] -> the rows they stand for [N, d]."""
    m = codes.shape[1]
    recon = torch.cat([cb.centroids[j][codes[:, j].long()]
                       for j in range(m)], dim=1)
    return recon @ cb.rotation.T


def adc_lut(cb: PQCodebook, q: torch.Tensor) -> torch.Tensor:
    """Per-subspace squared-distance tables for one query: [m, K]."""
    return adc_lut_batch(cb, q[None])[0]


def adc_lut_batch(cb: PQCodebook, q: torch.Tensor) -> torch.Tensor:
    """Per-subspace squared-distance tables for a query batch:
    [B, n] -> [B, m, K] f32."""
    m, _, dsub = cb.centroids.shape
    qs = (q.float() @ cb.rotation).reshape(q.shape[0], m, 1, dsub)
    diff = cb.centroids[None] - qs
    return (diff * diff).sum(-1)


def adc_scan(cb: PQCodebook, codes: torch.Tensor, q: torch.Tensor
             ) -> torch.Tensor:
    """Asymmetric distances of all codes [N, m] to one query: [N]. On the
    card the codes go to the kernel as uint8 (K <= 256)."""
    if codes.is_cuda and codes.dtype != torch.uint8:
        codes = codes.to(torch.uint8)
    return ops.pq_adc(codes, adc_lut(cb, q))
