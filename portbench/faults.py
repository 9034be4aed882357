"""Faults planted underneath the timed path, for the readings a cell's
limits are set from (``control.py --faults``) and for the CPU tests that
see ``correct`` come out false. Each is a function ``plant(patch)``
that swaps attributes of the port through ``patch(obj, name, value)``
(``pytest``'s ``monkeypatch.setattr``, or :func:`planted`).

  state_unchanged  a refinement step returns its running top-k as it
                   came in
  half_batch       the entry answers the first half of each batch; the
                   rest get no answer
  answer_altered   one lane's best id is changed where the step makes
                   it, its distance kept
  wrong_leaves     K1's lower bounds rolled by half the leaves: the
                   filter ranks, and the loop visits, the wrong leaves
  half_probes      the filter's budget halved: nprobe // 2 leaves a lane
  half_pool        each iteration scores half of every lane's gathered
                   slots (coop: K4's score pass sees half the pool)
  largest_kept     ``lex_select`` keeps each lane's largest scores
                   instead of its smallest (coop only)

The last four keep every answered distance true to its id: only which
rows an answer holds (``map_shortfall``) shows them.
"""

from __future__ import annotations

import contextlib

import torch


def state_unchanged(patch) -> None:
    from repro_torch.core import refine

    patch(refine, "refine_step",
          lambda ctx, pool, gi, ri, valid, top_d, top_i, **kw:
          (top_d, top_i))


def half_batch(patch) -> None:
    from repro_torch.core.engine import DistributedEngine

    orig = DistributedEngine.query

    def query(self, q, k, g, **kw):
        r = orig(self, q[: len(q) // 2], k, g, **kw)
        rest = len(q) - len(q) // 2
        dev = r.dists.device
        return r._replace(
            dists=torch.cat([r.dists, torch.full((rest, k), float("inf"),
                                                 device=dev)]),
            ids=torch.cat([r.ids, torch.full((rest, k), -1,
                                             dtype=r.ids.dtype,
                                             device=dev)]))

    patch(DistributedEngine, "query", query)


def answer_altered(patch) -> None:
    from repro_torch.core import refine

    orig = refine.refine_step

    def step(ctx, *a, **kw):
        d, i = orig(ctx, *a, **kw)
        i = i.clone()
        i[0, 0] = (i[0, 0] + 1) % (int(ctx.ids.max()) + 1)
        return d, i

    patch(refine, "refine_step", step)


def wrong_leaves(patch) -> None:
    from repro_torch.core import refine

    orig = refine.leaf_lower_bounds

    def bounds(index, queries):
        lb = orig(index, queries)
        return lb.roll(lb.shape[1] // 2, dims=1)

    patch(refine, "leaf_lower_bounds", bounds)


def half_probes(patch) -> None:
    from repro_torch.core.search import Refinement

    orig = Refinement.__init__

    def init(self, src, queries, k, *, nprobe=None, **kw):
        orig(self, src, queries, k,
             nprobe=None if nprobe is None else max(nprobe // 2, 1), **kw)

    patch(Refinement, "__init__", init)


def half_pool(patch) -> None:
    from repro_torch.core import refine

    orig = refine.refine_step

    def step(ctx, pool, gi, ri, valid, top_d, top_i, **kw):
        keep = torch.arange(valid.shape[1], device=valid.device) \
            < valid.shape[1] // 2
        return orig(ctx, pool, gi, ri, valid & keep, top_d, top_i, **kw)

    patch(refine, "refine_step", step)


def largest_kept(patch) -> None:
    from repro_torch.kernels import ref, topk

    def largest(orig):
        def select(scores, ids, kk):
            d, i = orig(-scores, ids, kk)  # masked slots: (inf, -1)
            d = torch.where(i >= 0, -d, float("inf"))
            o = torch.argsort(d, dim=1, stable=True)
            return d.gather(1, o), i.gather(1, o)
        return select

    # the card's selection, and the plain one the CPU takes
    patch(topk, "lex_select", largest(topk.lex_select))
    patch(ref, "ref_lex_select", largest(ref.ref_lex_select))


FAULTS = {f.__name__: f for f in (state_unchanged, half_batch,
                                  answer_altered, wrong_leaves, half_probes,
                                  half_pool, largest_kept)}


@contextlib.contextmanager
def planted(name: str):
    """The fault ``name`` planted for the block, undone after it."""
    saved = []

    def patch(obj, attr, value):
        saved.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, value)

    try:
        FAULTS[name](patch)
        yield
    finally:
        for obj, attr, value in reversed(saved):
            setattr(obj, attr, value)
