"""Serving policies: OServe + the paper's baselines (S5.1), as simulator
policies emitting per-span SpanDecisions.

  * OServePolicy        — predictor + two-level scheduler + ad hoc switching
  * VLLMStaticPolicy    — best single homogeneous deployment, fixed forever
  * VLLMReloadPolicy    — homogeneous deployments, re-optimized each span,
                          ad hoc switching enabled (the paper's vLLM (reload))
  * LlumnixPolicy       — fixed deployment + dynamic load-aware rebalancing
  * RoundRobinPolicy    — DeepSpeed-MII-style uniform dispatch
  * DynamoPolicy        — KV/load-aware routing, fixed per-worker parallelism

All policies share the cost model (fair comparison: same profiling data).

The port's copy of the JAX package's ``serving/baselines.py``.  The
policies are host code over the port's planner; ``OServePolicy``'s
``predictor`` may be the port's ``LSTMWorkloadPredictor``, which predicts
on its own device.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.assignment import assign_workloads
from repro_torch.core.costmodel import CostModel
from repro_torch.core.deployment import flow_guided_search
from repro_torch.core.orchestrator import Orchestrator, OrchestratorConfig
from repro_torch.core.types import (ClusterSpec, Deployment, WorkloadType,
                                    valid_strategies)
from repro_torch.serving.simulator import SpanDecision


def calibrate_rate(cm: CostModel, chips: int, archetypes: list[WorkloadType],
                   mix: np.ndarray, max_tp: int = 8, max_pp: int = 4,
                   utilization: float = 0.8) -> float:
    """Largest request rate (req/span) at which the cluster can serve the
    *proportional mix* (the paper sizes traces so the cluster is neither
    over- nor under-utilized), scaled by the target utilization.

    Binary search over the mixture scale; feasibility = the best deployment's
    max-flow serves >= 99.5% of the offered mix.
    """
    mix = np.asarray(mix, float)
    mix = mix / mix.sum()

    def feasible(total: float) -> bool:
        ws = [a.with_rate(float(total * m)) for a, m in zip(archetypes, mix)]
        sr = flow_guided_search(cm, chips, ws, max_tp=max_tp, max_pp=max_pp,
                                seed=0, patience=10)
        return sr.throughput >= 0.995 * total

    lo, hi = 1.0, 16.0
    while feasible(hi) and hi < 1e6:
        lo, hi = hi, hi * 2
    for _ in range(12):
        mid = 0.5 * (lo + hi)
        if feasible(mid):
            lo = mid
        else:
            hi = mid
    return lo * utilization


def _uniform_deployments(cm: CostModel, chips: int, max_tp: int = 8,
                         max_pp: int = 4) -> list[Deployment]:
    """All homogeneous deployments (identical replicas) filling the cluster."""
    out = []
    for per in range(cm.min_chips(), chips + 1):
        if chips % per:
            continue
        n = chips // per
        for s in valid_strategies(per, max_tp=max_tp, max_pp=max_pp):
            out.append(Deployment(tuple([s] * n)))
    return out


def _balanced_fractions(dep: Deployment, cm: CostModel,
                        workloads: list[WorkloadType]) -> list[list[float]]:
    """Capacity-proportional routing (no flow optimization)."""
    caps = np.array([[cm.capacity(r, w) for w in workloads]
                     for r in dep.replicas], dtype=float)
    col = caps.sum(0, keepdims=True)
    col[col == 0] = 1.0
    return (caps / col).tolist()


def _rates_to_workloads(archetypes: list[WorkloadType],
                        rates: np.ndarray) -> list[WorkloadType]:
    return [w.with_rate(float(r)) for w, r in zip(archetypes, rates)]


@dataclasses.dataclass
class PolicyStats:
    switches: int = 0
    search_seconds: float = 0.0
    switch_seconds_total: float = 0.0


class OServePolicy:
    """The full system: per-type prediction -> scheduler -> ad hoc switching."""

    def __init__(self, cm: CostModel, cluster: ClusterSpec,
                 archetypes: list[WorkloadType], predictor=None,
                 max_tp: int = 8, max_pp: int = 4, naive_reload: bool = False,
                 heterogeneous: bool = True, flow_assignment: bool = True):
        self.cm = cm
        self.orch = Orchestrator(cm, cluster, OrchestratorConfig(
            max_tp=max_tp, max_pp=max_pp))
        self.archetypes = archetypes
        self.predictor = predictor      # None -> oracle (uses observed rates)
        self.naive_reload = naive_reload
        self.heterogeneous = heterogeneous
        self.flow_assignment = flow_assignment
        self.history: list[np.ndarray] = []
        self.stats = PolicyStats()

    def observe(self, achieved: list[float]) -> None:
        """Simulator feedback: per-replica achieved/expected service for the
        last span; the orchestrator's EWMA health shifts the next span's
        assignment away from stragglers."""
        self.orch.observe_health(achieved)

    def _predict(self, observed: np.ndarray) -> np.ndarray:
        self.history.append(observed)
        if self.predictor is None:
            return observed
        hist = np.asarray(self.history)
        if len(hist) <= self.predictor.window:
            return observed
        return self.predictor.predict(hist)

    def decide(self, span: int, rates: np.ndarray,
               current: Deployment | None) -> SpanDecision:
        pred = self._predict(rates)
        ws = _rates_to_workloads(self.archetypes, pred)
        if not self.heterogeneous:
            dep, frac = _best_uniform(self.cm, self.orch.cluster.chips, ws)
            if self.flow_assignment:
                frac = assign_workloads(self.cm, dep, ws).fractions
            plan_dep, fractions = dep, frac
            switch = 0.0 if current == dep else (
                self.cm.reload_seconds() if self.naive_reload else 10.0)
            changed = list(range(dep.dp))
            self.orch.current = dep
            return SpanDecision(plan_dep, fractions, switch, changed)
        plan = self.orch.plan_span(ws)
        self.stats.search_seconds += plan.search_time
        if not self.flow_assignment:
            fractions = _balanced_fractions(plan.deployment, self.cm, ws)
        else:
            fractions = plan.fractions
        switch = plan.reload_seconds if self.naive_reload else plan.switch_seconds
        if plan.changed_replicas:
            self.stats.switches += 1
            self.stats.switch_seconds_total += switch
        return SpanDecision(plan.deployment, fractions, switch,
                            plan.changed_replicas)


def _best_uniform(cm: CostModel, chips: int, ws: list[WorkloadType]
                  ) -> tuple[Deployment, list[list[float]]]:
    best = None
    for dep in _uniform_deployments(cm, chips):
        res = assign_workloads(cm, dep, ws)
        key = (res.throughput, -res.latency_proxy())
        if best is None or key > best[0]:
            best = (key, dep, res)
    assert best is not None
    return best[1], best[2].fractions


class VLLMStaticPolicy:
    """Best homogeneous deployment for the *average* workload, fixed forever."""

    def __init__(self, cm: CostModel, cluster: ClusterSpec,
                 archetypes: list[WorkloadType], avg_rates: np.ndarray):
        ws = _rates_to_workloads(archetypes, avg_rates)
        self.dep, _ = _best_uniform(cm, cluster.chips, ws)
        self.cm = cm
        self.archetypes = archetypes

    def decide(self, span, rates, current) -> SpanDecision:
        ws = _rates_to_workloads(self.archetypes, rates)
        frac = _balanced_fractions(self.dep, self.cm, ws)
        return SpanDecision(self.dep, frac, 0.0,
                            None if current else list(range(self.dep.dp)))


class VLLMReloadPolicy(OServePolicy):
    """Homogeneous + adaptive + ad hoc switching (paper's vLLM (reload))."""

    def __init__(self, cm, cluster, archetypes, predictor=None, **kw):
        super().__init__(cm, cluster, archetypes, predictor,
                         heterogeneous=False, flow_assignment=False, **kw)


class RoundRobinPolicy(VLLMStaticPolicy):
    """MII-style: static deployment + uniform dispatch."""

    def decide(self, span, rates, current) -> SpanDecision:
        K, J = self.dep.dp, len(self.archetypes)
        frac = [[1.0 / K] * J for _ in range(K)]
        return SpanDecision(self.dep, frac, 0.0,
                            None if current else list(range(self.dep.dp)))


class LlumnixPolicy(VLLMStaticPolicy):
    """Static deployment, dynamic *load-aware* rebalancing each span.

    Captures Llumnix's request-migration benefit at span granularity: routing
    follows current per-type demand against replica capacity, but deployment
    (resources + parallelism) never changes.
    """

    def decide(self, span, rates, current) -> SpanDecision:
        ws = _rates_to_workloads(self.archetypes, rates)
        res = assign_workloads(self.cm, self.dep, ws)
        return SpanDecision(self.dep, res.fractions, 0.0,
                            None if current else list(range(self.dep.dp)))


class DynamoPolicy:
    """KV-aware routing + autoscaled pools, but fixed per-worker parallelism.

    The deployment is the best homogeneous one for the average workload; each
    span the router re-solves the assignment (KV/load-aware), which is the
    part Dynamo does well — the parallelism-workload interaction is what it
    misses (paper S5.2)."""

    def __init__(self, cm, cluster, archetypes, avg_rates):
        ws = _rates_to_workloads(archetypes, avg_rates)
        self.dep, _ = _best_uniform(cm, cluster.chips, ws)
        self.cm = cm
        self.archetypes = archetypes

    def decide(self, span, rates, current) -> SpanDecision:
        ws = _rates_to_workloads(self.archetypes, rates)
        res = assign_workloads(self.cm, self.dep, ws)
        return SpanDecision(self.dep, res.fractions, 0.0,
                            None if current else list(range(self.dep.dp)))
