"""OServe control loop (paper Appendix A) + failure/elasticity handling.

The port's copy of the JAX package's ``core/orchestrator.py``: the same
decisions from the same inputs, field for field.

Per time span:
  1. the workload predictor forecasts per-type arrival rates for the next span;
  2. the scheduler (S3) searches the serving strategy — heterogeneous model
     deployment + max-flow workload assignment — warm-started from the current
     deployment;
  3. if the deployment changed, the switch planner (S4.2) computes the ad hoc
     parameter-transfer plan and its cost (vs. a naive reload).

``on_cluster_change`` implements Appendix C: node failures / elastic resizes
re-run the same loop with the surviving chip count; EWMA health scaling
(straggler mitigation) shrinks a degraded replica's capacities so the flow
re-routes around it.

Observation hooks (fed by ``serving.cluster.ClusterRuntime`` and the
discrete-event simulator, not just by predictions):

  * ``observe_health(achieved_fraction)`` — per-replica achieved/expected
    throughput for the last span; the EWMA scales the current deployment's
    capacities in the next assignment, so traffic shifts away from
    stragglers.
  * ``observe_rates(rates)`` — realized per-type arrival counts; the EWMA
    is exposed via ``blended_workloads`` so callers can correct (or replace)
    the predictor's forecast with what actually arrived.
  * ``observe_inflight(context_lens, shared_pool)`` — context lengths the
    next deployment switch would have to migrate.  ``plan_span`` prices the
    KV migration (``switching.plan_kv_migration``) into the switch-cost
    term: a runtime whose replicas share one ``BlockPool`` migrates by page
    handoff (free), while a cross-pool cluster pays bytes-over-link — so
    plans prefer handoff-friendly switches and demand a larger predicted
    gain before a switch that would stall long in-flight contexts.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.core.assignment import assign_workloads
from repro_torch.core.costmodel import CostModel
from repro_torch.core.deployment import flow_guided_search, role_split_search
from repro_torch.core.switching import (PlacedDeployment, place_deployment,
                                  plan_kv_migration, plan_switch)
from repro_torch.core.types import ClusterSpec, Deployment, WorkloadType


@dataclasses.dataclass
class OrchestratorConfig:
    span_seconds: float = 60.0
    max_tp: int = 8
    max_pp: int = 4
    search_seed: int = 0
    search_patience: int = 20
    switch_hysteresis: float = 1.05   # require 5% predicted gain to switch
    ewma_alpha: float = 0.3
    # how strongly mid-span rebalance churn raises the switch bar: each
    # EWMA'd rebalance/preempt move adds this much to the hysteresis margin
    # (capped at +0.25), so a cluster the rebalancer is actively reshaping
    # demands a bigger predicted win before the planner reshapes it again
    rebalance_churn_gain: float = 0.02
    # consider disaggregated prefill/decode role splits on top of the
    # chip/strategy search (``deployment.role_split_search``); the
    # all-mixed deployment remains the baseline every split must beat
    disaggregate: bool = False


@dataclasses.dataclass
class SpanPlan:
    deployment: Deployment
    placed: PlacedDeployment
    fractions: list[list[float]]
    throughput: float
    switch_seconds: float       # param transfer + KV migration stall
    reload_seconds: float
    changed_replicas: list[int]
    search_time: float
    kv_migration_seconds: float = 0.0   # the KV share of switch_seconds


class Orchestrator:
    def __init__(self, cm: CostModel, cluster: ClusterSpec,
                 cfg: OrchestratorConfig | None = None):
        self.cm = cm
        self.cluster = cluster
        self.cfg = cfg or OrchestratorConfig()
        self.current: Deployment | None = None
        self.placed: PlacedDeployment | None = None
        self.health: np.ndarray | None = None   # per-replica EWMA in (0, 1]
        self.observed_rates: np.ndarray | None = None  # per-type EWMA
        self.prefix_hit_rate: np.ndarray | None = None  # per-type EWMA [0, 1]
        self.inflight_lens: list[int] = []      # contexts a switch migrates
        self.inflight_shared_pool: bool = True  # page handoff available?
        self.rebalance_churn = 0.0              # EWMA of moves per span
        # decision audit sink (serving.telemetry.DecisionAudit): when set
        # (by ClusterRuntime wiring a Telemetry bundle), every plan_span
        # decision records its inputs + predicted share for later joining
        # with the realized SpanReport into a calibration error
        self.audit = None

    # -- observation (health / stragglers, realized rates) ---------------------

    def observe_health(self, achieved_fraction: list[float]) -> None:
        """achieved/(expected) throughput per replica for the last span."""
        obs = np.clip(np.asarray(achieved_fraction, float), 0.05, 1.0)
        if self.health is None or len(self.health) != len(obs):
            self.health = obs
        else:
            a = self.cfg.ewma_alpha
            self.health = (1 - a) * self.health + a * obs

    def observe_rates(self, rates) -> None:
        """Realized per-type arrival counts for the last span (EWMA)."""
        obs = np.asarray(rates, float)
        if self.observed_rates is None or len(self.observed_rates) != len(obs):
            self.observed_rates = obs
        else:
            a = self.cfg.ewma_alpha
            self.observed_rates = (1 - a) * self.observed_rates + a * obs

    def observe_prefix_hits(self, hit_rates) -> None:
        """Per-type prefix-cache hit rates for the last span (EWMA).

        ``hit_rates[j]``: fraction of type j's prompt tokens served from
        the prefix cache this span (token-weighted).  NaN entries mean the
        type saw no admissions — their EWMA is left untouched rather than
        decayed toward zero.  ``plan_span`` feeds the EWMA into
        ``WorkloadType.cached_frac`` so the cost model discounts per-type
        prefill compute and steers shared-prefix-heavy types toward
        replicas whose pools are warm.
        """
        obs = np.asarray(hit_rates, float)
        if (self.prefix_hit_rate is None
                or len(self.prefix_hit_rate) != len(obs)):
            self.prefix_hit_rate = np.clip(np.nan_to_num(obs), 0.0, 1.0)
            return
        a = self.cfg.ewma_alpha
        seen = ~np.isnan(obs)
        blended = ((1 - a) * self.prefix_hit_rate
                   + a * np.clip(np.nan_to_num(obs), 0.0, 1.0))
        self.prefix_hit_rate = np.where(seen, blended, self.prefix_hit_rate)

    def observe_rebalance(self, moves: int) -> None:
        """Mid-span rebalancer activity for the last span (EWMA).

        ``moves``: sequences the cluster rebalancer migrated or preempted
        during the span.  High churn means the *intra*-span mechanism is
        already reshaping load — the planner then raises its switch
        hysteresis bar (see ``plan_span``) so the two control loops do not
        fight over the same imbalance."""
        a = self.cfg.ewma_alpha
        self.rebalance_churn = ((1 - a) * self.rebalance_churn
                                + a * float(moves))

    def observe_inflight(self, context_lens: list[int],
                         shared_pool: bool = True) -> None:
        """Record what a deployment switch decided now would migrate.

        ``context_lens``: current context (prompt + generated) of every
        in-flight request; ``shared_pool``: replicas partition one device
        pool, so migrations are page handoffs (zero bytes moved).
        """
        self.inflight_lens = [int(c) for c in context_lens]
        self.inflight_shared_pool = bool(shared_pool)

    def switch_kv_seconds(self, drain_threshold: int = 2048) -> float:
        """KV-migration stall a switch would add, per the last observation."""
        if not self.inflight_lens:
            return 0.0
        plan = plan_kv_migration(
            self.cm, dict(enumerate(self.inflight_lens)),
            drain_threshold=drain_threshold,
            shared_pool=self.inflight_shared_pool)
        return plan.estimate_seconds(self.cluster.hw)

    def blended_workloads(self, workloads: list[WorkloadType],
                          trust: float = 0.5) -> list[WorkloadType]:
        """Correct predicted rates with the observed-rate EWMA.

        ``trust`` is the weight on the observation (0 = pure prediction,
        1 = pure observation); with no observations yet, predictions pass
        through unchanged."""
        if (self.observed_rates is None
                or len(self.observed_rates) != len(workloads)):
            return list(workloads)
        return [w.with_rate((1 - trust) * w.rate + trust * float(o))
                for w, o in zip(workloads, self.observed_rates)]

    # -- the per-span decision ---------------------------------------------------

    def plan_span(self, workloads: list[WorkloadType],
                  force: bool = False) -> SpanPlan:
        t0 = time.time()
        # fold the observed per-type prefix-cache hit rate into the types
        # before pricing anything: the cost model then discounts prefill
        # compute for shared-prefix-heavy types (warm-pool steering)
        if (self.prefix_hit_rate is not None
                and len(self.prefix_hit_rate) == len(workloads)):
            workloads = [w.with_cached_frac(float(h))
                         for w, h in zip(workloads, self.prefix_hit_rate)]
        search = flow_guided_search(
            self.cm, self.cluster.chips, workloads,
            max_tp=self.cfg.max_tp, max_pp=self.cfg.max_pp,
            patience=self.cfg.search_patience, seed=self.cfg.search_seed,
            initial=self.current)
        new_dep, result = search.deployment, search.assignment
        if self.cfg.disaggregate and new_dep.dp >= 2:
            # role axis on top of the shape search: split the chosen
            # deployment into prefill/decode specialists when the
            # evaluator scores a split above the all-mixed baseline
            rd = role_split_search(self.cm, new_dep, workloads)
            if rd.replicas != new_dep.replicas:
                new_dep = rd
                result = assign_workloads(self.cm, new_dep, workloads)
        scale = None
        if (self.health is not None and self.current is not None
                and len(self.health) == self.current.dp):
            scale = list(self.health)

        # KV-migration stall the candidate switch would add (free when the
        # runtime migrates by page handoff): switching must clear a bar
        # raised by the stall's share of the span, so plans prefer
        # handoff-friendly switches.
        kv_s = 0.0
        if (self.current is not None
                and new_dep.replicas != self.current.replicas):
            kv_s = self.switch_kv_seconds()

        result_scaled = False
        margin = self.cfg.switch_hysteresis   # the gain bar actually applied
        if self.current is not None and not force:
            cur_res = assign_workloads(self.cm, self.current, workloads,
                                       capacity_scale=scale)
            # Switch only for a clear win: >hysteresis gain in served demand
            # or in stressed capacity (robust headroom), or the same
            # throughput at materially lower peak utilization (queueing).
            stressed = [w.with_rate(w.rate * 2.0) for w in workloads]
            new_cap = assign_workloads(self.cm, new_dep, stressed,
                                       balance=False).throughput
            cur_cap = assign_workloads(self.cm, self.current, stressed,
                                       balance=False).throughput
            h = (self.cfg.switch_hysteresis
                 + kv_s / self.cfg.span_seconds
                 + min(0.25, self.cfg.rebalance_churn_gain
                       * self.rebalance_churn))
            margin = h
            thr_gain = result.throughput > h * cur_res.throughput
            cap_gain = (result.throughput >= 0.999 * cur_res.throughput
                        and new_cap > h * cur_cap)
            lat_gain = (result.throughput >= 0.999 * cur_res.throughput
                        and new_cap >= 0.999 * cur_cap
                        and kv_s <= 0.05 * self.cfg.span_seconds
                        and result.latency_proxy()
                        < 0.95 * cur_res.latency_proxy())
            if not (thr_gain or cap_gain or lat_gain):
                new_dep, result = self.current, cur_res
                kv_s = 0.0               # no switch -> nothing migrates
            result_scaled = result is cur_res

        # Health must reach the routed fractions even when the *search* wins
        # with the structurally-same deployment: re-solve its assignment under
        # the EWMA capacity scale so stragglers shed traffic either way
        # (skipped when the kept result already carries the scale).
        if (scale is not None and self.current is not None
                and new_dep.replicas == self.current.replicas
                and not result_scaled):
            result = assign_workloads(self.cm, new_dep, workloads,
                                      capacity_scale=scale)

        switch_s = 0.0
        reload_s = self.cm.reload_seconds()
        changed: list[int] = list(range(new_dep.dp))
        new_placed = place_deployment(new_dep, self.cluster)
        if (self.placed is not None and self.current is not None
                and new_dep.replicas == self.current.replicas):
            changed = []
            kv_s = 0.0
        elif self.placed is not None:
            plan = plan_switch(self.placed, new_placed, self.cm,
                               self.cluster.hw)
            switch_s = plan.estimate_seconds(self.cluster.hw) + kv_s
        self.current, self.placed = new_dep, new_placed
        plan = SpanPlan(new_dep, new_placed, result.fractions,
                        result.throughput, switch_s, reload_s, changed,
                        time.time() - t0, kv_migration_seconds=kv_s)
        if self.audit is not None:
            # workloads already carry the cached_frac EWMA folded in above
            self.audit.record_plan(plan, workloads, health=scale,
                                   hysteresis_margin=margin,
                                   kv_stall_s=kv_s,
                                   switched=bool(changed))
        return plan

    # -- fault tolerance / elasticity (Appendix C) -------------------------------

    def observe_failures(self, dead_replicas: list[int],
                         surviving_chips: int) -> None:
        """Replica deaths reported by the runtime: shrink the chip budget
        and prune the dead replicas from the planner's deployment state.

        ``dead_replicas`` index the deployment the runtime was running
        (cluster replica order == ``current.replicas`` order after an
        applied plan).  Pruning keeps ``current``'s total chips equal to
        the surviving budget, so the next ``plan_span`` both warm-starts
        from and compares against a deployment that is actually feasible —
        degraded-mode replanning re-solves over the survivors.  Health
        entries are pruned in lockstep so EWMA state stays aligned.
        """
        self.cluster = ClusterSpec(int(surviving_chips), self.cluster.hw)
        dead = set(dead_replicas)
        if self.current is not None:
            alive = tuple(rc for i, rc in enumerate(self.current.replicas)
                          if i not in dead)
            self.current = Deployment(alive) if alive else None
        if self.placed is not None:
            alive_p = tuple(r for i, r in enumerate(self.placed.replicas)
                            if i not in dead)
            self.placed = PlacedDeployment(alive_p) if alive_p else None
        if self.health is not None:
            keep = [a for i, a in enumerate(self.health) if i not in dead]
            self.health = np.asarray(keep) if keep else None

    def observe_rejoin(self, live_replicas: tuple, surviving_chips: int,
                       health_index: int | None = None) -> None:
        """A dead replica was repaired: re-admit its chips to the planning
        budget and point the planner's deployment state at what the runtime
        now runs (inverse of ``observe_failures``).

        ``live_replicas``: the full live ``ReplicaConfig`` tuple in cluster
        order after the repair; ``health_index``: the repaired replica's
        position within it — a neutral health entry (1.0) is inserted there
        so the EWMA stays aligned and the rebuilt replica starts with a
        clean record rather than inheriting its dying throughput.
        """
        self.cluster = ClusterSpec(int(surviving_chips), self.cluster.hw)
        if not live_replicas:
            return
        self.current = Deployment(tuple(live_replicas))
        self.placed = place_deployment(self.current, self.cluster)
        if self.health is not None and health_index is not None:
            if len(self.health) == len(live_replicas) - 1:
                self.health = np.insert(self.health, health_index, 1.0)
            elif len(self.health) != len(live_replicas):
                self.health = None    # stale shape: restart the EWMA

    def on_switch_rollback(self, live_replicas: tuple) -> None:
        """A transactional switch failed and the runtime restored the old
        deployment: point the planner back at what is actually running
        (the most recent ``plan_span`` had already committed the new
        deployment to ``current``/``placed``)."""
        if not live_replicas:
            self.current = None
            self.placed = None
            return
        self.current = Deployment(tuple(live_replicas))
        self.placed = place_deployment(self.current, self.cluster)

    def on_cluster_change(self, new_chips: int,
                          workloads: list[WorkloadType]) -> SpanPlan:
        """Node failure or elastic resize: re-plan on the surviving chips.

        The switch plan sources only from chips present in both clusters, so
        a shrink never reads from dead devices.
        """
        self.cluster = ClusterSpec(new_chips, self.cluster.hw)
        # keep the old placement for switch-plan sourcing, but search fresh:
        # the warm-started mutation loop preserves total chips, which no
        # longer matches the pool
        if self.placed is not None and new_chips < self.placed.all_chips[-1] + 1:
            # shrink: drop shards on dead chips from the source set
            surviving = []
            for rep in self.placed.replicas:
                if all(c < new_chips for c in rep.chips):
                    surviving.append(rep)
            self.placed = (PlacedDeployment(tuple(surviving))
                           if surviving else None)
        self.current = None
        return self.plan_span(workloads, force=True)
