"""The comparison that decides ``correct`` for a k-NN answer.

Each lane's answer is k ids with their distances. Three numbers are
compared, each with a limit of its own:

  bad_lanes    lanes whose answer is not k distinct ids of the
               collection with finite distances in ascending order
               (limit 0: an exact comparison)
  sq_dist_gap  the widest gap, over every id answered, between the
               squared distance the answer gives for it and the id's
               squared distance recomputed here in the difference form
               sum((q - x)^2) in f32, which no matmul precision touches
  map_shortfall  1 - the MAP of every answer against the plain
               reference's exact k nearest (``reference/knn.py``)

A row of the collection that comes back with a wrong distance, another
row's id, a lane left unanswered or a step that never scored shows in
the first two. An ng answer holds the k nearest rows of the nprobe
leaves the filter ranks first, not the exact k nearest, so its MAP
falls short of 1 by an amount its configuration fixes; a filter that
visits other or fewer leaves, or a selection that keeps other rows,
makes it fall further, with every distance still true to its id.
"""

from __future__ import annotations

import torch

from portbench.frozen import accuracy

NAMES = ("bad_lanes", "sq_dist_gap", "map_shortfall")


def judge(collection: torch.Tensor, queries: torch.Tensor,
          ids: torch.Tensor, dists: torch.Tensor, true_ids: torch.Tensor,
          *, lane_block: int = 2048) -> dict:
    """Readings over every lane of ``ids`` and ``dists`` [Q, k] for the
    ``queries`` [Q, n], whose exact k nearest are ``true_ids`` [Q, k]:
    the three numbers above, ``lanes``, ``map`` and ``recall``, and per
    lane ``lane_bad``, ``lane_gap`` and ``lane_ap`` [Q] (on the host),
    from which :func:`failed` counts the lanes that fail."""
    x = collection
    n_rows = x.shape[0]
    lane_bad, lane_gap, lane_ap, lane_rec = [], [], [], []
    for s in range(0, ids.shape[0], lane_block):
        i = ids[s:s + lane_block].to(x.device, torch.int64)
        t = true_ids[s:s + lane_block].to(x.device, torch.int64)
        lane_ap.append(accuracy.average_precision(i, t).cpu())
        lane_rec.append(accuracy.recall(i, t).cpu())
        d = dists[s:s + lane_block].to(x.device, torch.float32)
        q = queries[s:s + lane_block].to(x.device, torch.float32)
        in_range = (i >= 0) & (i < n_rows)
        srt = torch.sort(i, dim=1).values
        distinct = (srt[:, 1:] != srt[:, :-1]).all(1)
        finite = torch.isfinite(d).all(1)
        ascending = (d[:, 1:] >= d[:, :-1]).all(1)
        ok = in_range.all(1) & distinct & finite & ascending
        lane_bad.append((~ok).cpu())
        rows = x[torch.where(in_range, i, 0)]
        diff = rows - q[:, None, :]
        exact = (diff * diff).sum(-1)
        g = torch.where(in_range & torch.isfinite(d),
                        (d * d - exact).abs(), 0.0)
        lane_gap.append(g.amax(1).cpu())
    lane_bad = torch.cat(lane_bad)
    lane_gap = torch.cat(lane_gap)
    lane_ap = torch.cat(lane_ap)
    ap = float(lane_ap.double().mean())
    return {"lanes": int(ids.shape[0]), "bad_lanes": int(lane_bad.sum()),
            "sq_dist_gap": float(lane_gap.max()), "map_shortfall": 1.0 - ap,
            "map": ap, "recall": float(torch.cat(lane_rec).double().mean()),
            "lane_bad": lane_bad, "lane_gap": lane_gap, "lane_ap": lane_ap}


def failed(readings: dict, limits: dict) -> int:
    """Lanes that fail: a bad lane, one whose widest gap is past the
    ``sq_dist_gap`` limit, and, where the MAP falls short by more than
    its limit, every lane whose own AP does."""
    bad = readings["lane_bad"] | (readings["lane_gap"]
                                  > limits["sq_dist_gap"])
    if readings["map_shortfall"] > limits["map_shortfall"]:
        bad |= 1.0 - readings["lane_ap"] > limits["map_shortfall"]
    return int(bad.sum())


def checks(readings: dict, limits: dict) -> dict:
    """{name: {"value", "limit"}} for every compared number, in the
    order printed."""
    return {name: {"value": readings[name], "limit": limits[name]}
            for name in NAMES}


def passed(readings: dict, limits: dict) -> bool:
    return all(c["value"] <= c["limit"]
               for c in checks(readings, limits).values())
