"""The serving loop: bucketed batch decode + retrieval-augmented answers.

The port's copy of ``src/repro/launch/serve.py``. Drives
serve/batching.Scheduler over serve/serve_step.generate, with a retrieval
engine as a first-class feature: each request may carry a ``series``
query in the engine's series space, and the scheduler's retrieval front
partitions every drained batch by its deadline-mapped guarantee (epsilon
-> delta-epsilon -> ng(nprobe)) and issues one ``engine.query`` per
group. The engine decides residency per shard (core/engine.py), so the
same front covers collections larger than device memory.

Every request's latency is made of its own components on the port's one
clock (``repro_torch.clock.now``, on which ``Request.submitted_at`` is
stamped):

  queue_wait_ms   submit -> its batch starts draining
  generate_ms     the decode of its batch (shared by the batch), up to
                  the tokens' read-back to the host
  retrieval_ms    its own guarantee group's engine time

They land in the metrics registry as the ``serve.queue_wait_ms``,
``serve.generate_ms`` and ``serve.latency_ms{kind}`` histograms and the
``serve.deadline.{hit,miss}{kind}`` counters; each drained batch is a
``serve.batch`` span, its decode a ``serve.generate`` span, when tracing
is on.

Two fronts: :func:`serve_requests` is the static barrier loop (drain a
batch, decode it, retrieve for it, repeat), and
:func:`serve_requests_continuous` submits each request's retrieval to a
:class:`~repro_torch.serve.loop.ServeFront` when it arrives, so engine
calls overlap the decode batches.

Prompts are left-padded with token 0 and no attention mask
(``Scheduler.pad_prompts``), as the reference pads them.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from repro_torch import obs
from repro_torch.clock import now
from repro_torch.configs.base import ModelConfig
from repro_torch.serve.batching import (Request, Scheduler,
                                        guarantee_for_deadline)
from repro_torch.serve.loop import Rejected, ServeFront
from repro_torch.serve.serve_step import generate

__all__ = ["serve_requests", "serve_requests_continuous"]


def _decode(params, cfg: ModelConfig, sched: Scheduler, bucket: int,
            reqs: List[Request]):
    """One drained batch through generate: (tokens [B, n] on the host,
    generate_ms). The read-back waits for the device inside the timed
    window."""
    prompts = sched.pad_prompts(bucket, reqs)
    n_new = max(r.max_new_tokens for r in reqs)
    with obs.span("serve.generate", tokens=n_new):
        t0 = now()
        toks, _aux = generate(params, cfg, prompts, n_new)
        toks = toks.cpu()
        generate_ms = (now() - t0) * 1e3
    return toks.numpy(), generate_ms


def serve_requests(
    params,
    cfg: ModelConfig,
    requests: List[Request],
    *,
    engine=None,
    retrieval_k: int = 5,
    max_batch: int = 8,
    guarantee_kw: Optional[dict] = None,
) -> Dict[int, Dict[str, Any]]:
    """Serve a request list to completion. With ``engine`` set, every
    request carrying a ``series`` query gets a ``retrieval`` entry
    ({ids, dists, kind, stats}) answered under the guarantee its deadline
    affords; ``guarantee_kw`` tunes the deadline->guarantee mapping. Each
    result entry carries the per-request latency breakdown
    (queue_wait_ms / generate_ms / retrieval_ms / latency_ms) and a
    ``deadline_hit`` flag when the request had a deadline."""
    sched = Scheduler(max_batch=max_batch)
    for r in requests:
        sched.submit(r)
    gkw = dict(guarantee_kw or {})
    results: Dict[int, Dict[str, Any]] = {}
    reg = obs.REGISTRY
    while True:
        nb = sched.next_batch()
        if nb is None:
            break
        bucket, reqs = nb
        with obs.span("serve.batch", bucket=bucket, requests=len(reqs)):
            t_drain = now()
            toks, generate_ms = _decode(params, cfg, sched, bucket, reqs)
            retrieved: Dict[int, Dict[str, Any]] = {}
            if engine is not None:
                # one engine.query per deadline-mapped guarantee group,
                # overlapping nothing: retrieval is part of the budget
                retrieved = sched.run_retrieval(
                    engine, reqs, retrieval_k, **gkw)
            for i, r in enumerate(reqs):
                kind = guarantee_for_deadline(r.deadline_ms, **gkw).kind
                queue_wait_ms = max((t_drain - r.submitted_at) * 1e3, 0.0)
                retrieval_ms = retrieved.get(r.uid, {}).get(
                    "retrieval_ms", 0.0)
                latency_ms = queue_wait_ms + generate_ms + retrieval_ms
                entry: Dict[str, Any] = {
                    "tokens": toks[i, : r.max_new_tokens],
                    "latency_ms": latency_ms,
                    "queue_wait_ms": queue_wait_ms,
                    "generate_ms": generate_ms,
                    "retrieval_ms": retrieval_ms,
                    "guarantee": kind,
                }
                reg.histogram("serve.queue_wait_ms").record(queue_wait_ms)
                reg.histogram("serve.generate_ms").record(generate_ms)
                reg.histogram("serve.latency_ms", kind=kind).record(
                    latency_ms)
                if r.deadline_ms is not None:
                    hit = latency_ms <= r.deadline_ms
                    entry["deadline_hit"] = bool(hit)
                    reg.counter("serve.deadline.hit" if hit
                                else "serve.deadline.miss", kind=kind).inc()
                if r.uid in retrieved:
                    hit_r = retrieved[r.uid]
                    entry["retrieval"] = {
                        "ids": hit_r["ids"], "dists": hit_r["dists"],
                        "kind": hit_r["kind"], "stats": hit_r.get("stats"),
                    }
                    if hit_r.get("degraded"):
                        # shards lost past retries and replicas: the answer
                        # is honest delta-epsilon, not the requested tier
                        entry["retrieval"].update(
                            degraded=True,
                            requested_kind=hit_r["requested_kind"],
                            effective_delta=hit_r["effective_delta"],
                            shards_lost=hit_r["shards_lost"])
                results[r.uid] = entry
    return results


def serve_requests_continuous(
    params,
    cfg: ModelConfig,
    requests: List[Request],
    *,
    engine=None,
    retrieval_k: int = 5,
    max_batch: int = 8,
    guarantee_kw: Optional[dict] = None,
    admission=None,
) -> Dict[int, Dict[str, Any]]:
    """Serve a request list with retrieval on the continuous front.

    Retrieval is submitted to a :class:`ServeFront` the moment a request
    enters the system, so engine calls overlap the decode batches. Each
    request's ``latency_ms`` is the later of its decode completion and
    its retrieval completion minus its submit stamp. A request rejected
    by admission control (``admission`` caps in-system retrieval depth)
    still decodes; its entry carries ``retrieval_rejected`` with the
    reason. The front remaps guarantees from the remaining deadline
    budget at drain time and degrades tiers under shedding: the
    ``retrieval`` entry's ``kind`` is the tier actually honoured."""
    sched = Scheduler(max_batch=max_batch)
    gkw = dict(guarantee_kw or {})
    tickets: Dict[int, Any] = {}
    rejected: Dict[int, str] = {}
    front = None
    if engine is not None:
        front = ServeFront(engine, retrieval_k, max_batch=max_batch,
                           admission=admission, guarantee_kw=gkw).start()
    try:
        for r in requests:
            sched.submit(r)
            if front is not None and r.series is not None:
                try:
                    tickets[r.uid] = front.submit(r)
                except Rejected as e:
                    rejected[r.uid] = e.reason
        results: Dict[int, Dict[str, Any]] = {}
        decode_done: Dict[int, float] = {}
        while True:
            nb = sched.next_batch()
            if nb is None:
                break
            bucket, reqs = nb
            with obs.span("serve.batch", bucket=bucket, requests=len(reqs)):
                t_drain = now()
                toks, generate_ms = _decode(params, cfg, sched, bucket, reqs)
                for i, r in enumerate(reqs):
                    results[r.uid] = {
                        "tokens": toks[i, : r.max_new_tokens],
                        "queue_wait_ms": max(
                            (t_drain - r.submitted_at) * 1e3, 0.0),
                        "generate_ms": generate_ms,
                        "retrieval_ms": 0.0,
                    }
                    decode_done[r.uid] = now()
        if front is not None:
            front.stop(drain=True)
            front = None
        reg = obs.REGISTRY
        for r in requests:
            entry = results[r.uid]
            done = decode_done[r.uid]
            kind = guarantee_for_deadline(r.deadline_ms, **gkw).kind
            if r.uid in tickets:
                hit_r = tickets[r.uid].result()
                if "error" in hit_r:
                    entry["retrieval_error"] = hit_r["error"]
                else:
                    entry["retrieval_ms"] = hit_r["retrieval_ms"]
                    done = max(done, hit_r["done_at"])
                    kind = hit_r["kind"]
                    entry["retrieval"] = {
                        k: hit_r[k] for k in
                        ("ids", "dists", "kind", "nominal_kind", "stats")}
                    for extra in ("shed", "degraded", "requested_kind",
                                  "effective_delta", "shards_lost"):
                        if extra in hit_r:
                            entry["retrieval"][extra] = hit_r[extra]
            elif r.uid in rejected:
                entry["retrieval_rejected"] = rejected[r.uid]
            latency_ms = max((done - r.submitted_at) * 1e3, 0.0)
            entry["latency_ms"] = latency_ms
            entry["guarantee"] = kind
            reg.histogram("serve.queue_wait_ms").record(
                entry["queue_wait_ms"])
            reg.histogram("serve.generate_ms").record(entry["generate_ms"])
            reg.histogram("serve.latency_ms", kind=kind).record(latency_ms)
            if r.deadline_ms is not None:
                hit = latency_ms <= r.deadline_ms
                entry["deadline_hit"] = bool(hit)
                reg.counter("serve.deadline.hit" if hit
                            else "serve.deadline.miss", kind=kind).inc()
        return results
    finally:
        if front is not None:
            front.stop(drain=False)
