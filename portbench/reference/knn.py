"""Exact k nearest neighbours by brute force, in f32 with TF32 off.

The squared distances come in the expanded form |q|^2 + |x|^2 - 2 q.x,
one matmul per block of queries over every row, and the k smallest are
kept. ``tf32=True`` is the control: the same computation with the matmul
in TF32, the precision below the configuration's. On the card that is
the TF32 matmul itself; on the CPU, which has none, both operands are
rounded to TF32's 10-bit mantissa (round to nearest even) before an f32
matmul, which is what the tensor cores compute.
"""

from __future__ import annotations

import contextlib

import torch


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """x (f32) rounded to the nearest TF32 value, ties to even."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """The CUDA matmul in TF32 (``tf32``) or in IEEE f32, restored
    after."""
    m = torch.backends.cuda.matmul
    old = m.allow_tf32
    m.allow_tf32 = tf32
    try:
        yield
    finally:
        m.allow_tf32 = old


def knn(collection: torch.Tensor, queries: torch.Tensor, k: int, *,
        tf32: bool = False, q_block: int = 512) -> tuple:
    """(squared distances [Q, k] ascending, row ids [Q, k] int64) of each
    query's k nearest rows of ``collection`` [N, n], on the collection's
    device."""
    x = collection
    emulate = tf32 and x.device.type != "cuda"
    xm = round_tf32(x) if emulate else x
    xn = (x * x).sum(1)
    out_d, out_i = [], []
    with matmul_precision(tf32 and not emulate):
        for s in range(0, queries.shape[0], q_block):
            q = queries[s:s + q_block].to(x.device, torch.float32)
            qn = (q * q).sum(1)
            qm = round_tf32(q) if emulate else q
            d = torch.addmm(qn[:, None] + xn[None, :], qm, xm.T,
                            alpha=-2.0)
            v, i = torch.topk(d, k, dim=1, largest=False, sorted=True)
            out_d.append(v)
            out_i.append(i)
            del d
    return torch.cat(out_d), torch.cat(out_i)
