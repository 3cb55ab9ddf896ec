"""Discrete-event serving simulator (drives the paper's e2e experiments).

Model (faithful to continuous batching):
  * each replica is a G/G/c multi-slot server: c = the cost model's effective
    decode batch for the replica's *assigned blend* of types; a request holds
    one slot for its full residence time response_j = prefill + out_len *
    decode_step(blend);
  * co-batched long-context sequences slow every decode step on the replica
    (shared KV reads), so both residency and capacity degrade with the blend
    — the interference that the scheduler's type segregation removes;
  * deployment switches happen at span boundaries: replicas whose
    configuration changed are blocked from admitting new requests for the
    switch duration (ad hoc transfer vs naive reload — the policy decides);
    queued requests are re-routed through the new assignment (KV migration
    per paper S4.2).

The port's copy of the JAX package's ``serving/simulator.py``: a
discrete-event loop on the host in numpy float64, with the same event heap
and tie-breaks, so the same trace and policy give the same request times
in both packages.  It has no device work.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Protocol

import numpy as np

from repro_torch.core.costmodel import CostModel
from repro_torch.core.types import Deployment, WorkloadType
from repro_torch.serving.request import Request


@dataclasses.dataclass
class SpanDecision:
    deployment: Deployment
    fractions: list[list[float]]          # [k][j]
    switch_seconds: float = 0.0           # applied to changed replicas
    changed: list[int] | None = None      # replica indices blocked during switch


class Policy(Protocol):
    def decide(self, span: int, rates: np.ndarray, current: Deployment | None
               ) -> SpanDecision: ...
    # Policies may also define observe(achieved: list[float]) — the simulator
    # reports each replica's achieved/expected service fraction for the span
    # that just ended (requests that began service / requests routed), the
    # same health signal ClusterRuntime feeds Orchestrator.observe_health.


@dataclasses.dataclass
class SimResult:
    requests: list[Request]
    spans: int
    span_seconds: float
    deployments: list[str]
    switch_spans: int
    dropped: int

    def metrics(self) -> dict:
        lat = np.array([r.latency for r in self.requests if r.finish >= 0])
        done = len(lat)
        ttft = np.array([r.ttft for r in self.requests if r.first_token >= 0])
        dur = self.spans * self.span_seconds
        out = {"completed": done, "throughput_rps": done / dur,
               "dropped": self.dropped}
        # goodput: only requests inside their TTFT + TPOT budgets count
        # (requests without budgets — inf — count whenever they finish)
        good = sum(1 for r in self.requests if r.slo_met)
        out["goodput_rps"] = good / dur
        out["slo_attainment"] = good / max(len(self.requests), 1)
        if done:
            out.update(
                avg_latency=float(lat.mean()),
                p50=float(np.percentile(lat, 50)),
                p90=float(np.percentile(lat, 90)),
                p95=float(np.percentile(lat, 95)),
                p99=float(np.percentile(lat, 99)),
                p99_ttft=float(np.percentile(ttft, 99)) if len(ttft) else 0.0,
            )
        return out

    def span_metrics(self, span: int) -> dict:
        lo, hi = span * self.span_seconds, (span + 1) * self.span_seconds
        rs = [r for r in self.requests if lo <= r.arrival < hi]
        lat = np.array([r.latency for r in rs if r.finish >= 0])
        return {"n": len(rs),
                "p99": float(np.percentile(lat, 99)) if len(lat) else float("inf"),
                "avg": float(lat.mean()) if len(lat) else float("inf")}


class _ReplicaSim:
    """Continuous-batching replica: c parallel slots + FIFO admission queue."""

    def __init__(self, rid: int, slots: int):
        self.rid = rid
        self.slots = max(1, slots)
        self.busy: list[float] = []               # end-times heap
        self.queue: list[tuple[float, int]] = []  # (arrival, req idx)
        self.blocked_until = 0.0
        self.work_queued = 0.0                    # slot-seconds waiting

    def free_at(self, now: float) -> bool:
        while self.busy and self.busy[0] <= now + 1e-9:
            heapq.heappop(self.busy)
        return len(self.busy) < self.slots and now >= self.blocked_until

    def wait_estimate(self, now: float) -> float:
        backlog = self.work_queued / self.slots
        if len(self.busy) >= self.slots and self.busy:
            backlog += max(0.0, self.busy[0] - now)
        return backlog + max(0.0, self.blocked_until - now)


def simulate(
    requests: list[Request],
    policy,
    cm: CostModel,
    workloads: list[WorkloadType],
    n_spans: int,
    span_seconds: float = 60.0,
    queue_cap_seconds: float = 240.0,
) -> SimResult:
    """Run the trace through the policy-controlled cluster."""
    J = len(workloads)
    counts = np.zeros((n_spans, J))
    for r in requests:
        s = min(int(r.arrival // span_seconds), n_spans - 1)
        counts[s, r.type_id] += 1

    deployment: Deployment | None = None
    replicas: list[_ReplicaSim] = []
    span_routed: list[list[int]] = []     # [k] -> request idx routed this span
    perf: list[list] = []
    response: list[list[float]] = []   # [k][j] residence under the blend
    fractions = None
    sent = seen = None
    deployments_log: list[str] = []
    switch_spans = 0
    dropped = 0

    events: list[tuple] = []
    for i, r in enumerate(requests):
        heapq.heappush(events, (r.arrival, 2 * i + 1, "arrive", i))
    for s in range(n_spans):
        heapq.heappush(events, (s * span_seconds, 2 * s, "span", s))

    ctxs = np.array([w.in_len + w.out_len // 2 for w in workloads], float)

    def configure(dep: Deployment, fracs: np.ndarray, rates: np.ndarray):
        """(Re)build blended residence times + per-replica slot counts."""
        nonlocal perf, response
        perf = [[cm.replica_perf(rc, w) for w in workloads]
                for rc in dep.replicas]
        response = []
        slot_counts = []
        for k, rc in enumerate(dep.replicas):
            share = fracs[k] * np.maximum(rates, 0.0)
            tot = share.sum()
            blend = float((share * ctxs).sum() / tot) if tot > 0 else None
            row = []
            c_est = 0.0
            for j, w in enumerate(workloads):
                p = perf[k][j]
                if not p.fits:
                    row.append(float("inf"))
                    continue
                ctx = int(max(blend if blend is not None else ctxs[j],
                              w.in_len))
                dstep = cm.measure_decode_step(rc, p.b_eff, ctx)
                row.append(p.prefill_time + w.out_len * dstep)
                weight = share[j] / tot if tot > 0 else 1.0 / J
                c_est += p.b_eff * weight
            response.append(row)
            slot_counts.append(max(1, int(round(c_est))))
        return slot_counts

    def start_next(k: int, now: float):
        rep = replicas[k]
        while rep.queue and rep.free_at(now):
            _, idx = heapq.heappop(rep.queue)
            r = requests[idx]
            resp = response[k][r.type_id]
            if resp == float("inf"):
                nonlocal dropped
                dropped += 1
                continue
            rep.work_queued = max(0.0, rep.work_queued - resp)
            r.start = now
            r.first_token = now + perf[k][r.type_id].prefill_time
            r.finish = now + resp
            heapq.heappush(rep.busy, r.finish)
            heapq.heappush(events, (r.finish, 2 * idx + 1, "free", k))

    def route(r: Request, now: float) -> int:
        nonlocal sent, seen
        j = r.type_id
        seen[j] += 1
        deficit = fractions[:, j] * seen[j] - sent[:, j]
        for k in range(len(replicas)):
            if response[k][j] == float("inf"):
                deficit[k] = -np.inf
        k = int(np.argmax(deficit))
        sent[k, j] += 1
        return k

    while events:
        now, _, kind, payload = heapq.heappop(events)
        if kind == "span":
            s = payload
            rates = counts[s]
            # report the ended span's per-replica achieved fraction (requests
            # that began service / requests routed) before the next decision
            observe = getattr(policy, "observe", None)
            if observe is not None and replicas and any(span_routed):
                achieved = [
                    (sum(1 for i in routed if requests[i].start >= 0)
                     / len(routed)) if routed else 1.0
                    for routed in span_routed]
                observe(achieved)
            decision = policy.decide(s, rates, deployment)
            new_dep = decision.deployment
            fracs = np.asarray(decision.fractions, dtype=np.float64)
            if deployment is None or new_dep.replicas != deployment.replicas:
                if deployment is not None:
                    switch_spans += 1
                old_queues = [rep.queue for rep in replicas]
                deployment = new_dep
                slot_counts = configure(deployment, fracs, rates)
                K = len(deployment.replicas)
                replicas = [_ReplicaSim(k, slot_counts[k]) for k in range(K)]
                changed = (decision.changed if decision.changed is not None
                           else list(range(K)))
                for k in changed:
                    replicas[k].blocked_until = now + decision.switch_seconds
                sent = np.zeros((K, J))
                seen = np.zeros(J)
                fractions = fracs
                span_routed = [[] for _ in replicas]
                # re-route carried-over requests through the new assignment
                # (KV migrated per paper S4.2)
                for item in sorted(i for q in old_queues for i in q):
                    r = requests[item[1]]
                    k = route(r, now)
                    heapq.heappush(replicas[k].queue, item)
                    span_routed[k].append(item[1])
                    resp = response[k][r.type_id]
                    if resp != float("inf"):
                        replicas[k].work_queued += resp
            else:
                fractions = fracs
                slot_counts = configure(deployment, fracs, rates)
                for k, rep in enumerate(replicas):
                    rep.slots = slot_counts[k]
                span_routed = [[] for _ in replicas]
            deployments_log.append(str(deployment))
            for k in range(len(replicas)):
                start_next(k, now)
        elif kind == "arrive":
            r = requests[payload]
            if deployment is None:
                dropped += 1
                continue
            k = route(r, now)
            rep = replicas[k]
            resp = response[k][r.type_id]
            if (resp == float("inf")
                    or rep.wait_estimate(now) > queue_cap_seconds):
                dropped += 1
                continue
            r.replica = k
            rep.work_queued += resp
            heapq.heappush(rep.queue, (r.arrival, payload))
            span_routed[k].append(payload)
            start_next(k, now)
        else:  # free
            if payload < len(replicas):
                start_next(payload, now)

    return SimResult(requests, n_spans, span_seconds, deployments_log,
                     switch_spans, dropped)
