"""Real-compute validation: orchestrator plans on live engines.

The port of the JAX package's ``serving/validation.py``, driven by
``python -m repro_torch.serve_orchestrated --real``: plans are made by the
port's ``Orchestrator`` against the paper-scale cost model, executed by its
``ClusterRuntime`` on a smoke-scale model, and each span's
planner-predicted per-replica traffic share is scored against the share the
engines actually served.  The runtime lives on the card unless
``device="cpu"`` is passed.

The requests executed are tiny per-type stand-ins of the paper archetypes,
so the comparison is about routing shares, switch execution (drain /
migrate counters), and the health/rate feedback loop — not absolute
throughput.  Requests deliberately remain in flight across span boundaries
(no mid-run flush) so every deployment change exercises the live
drain/export/migrate path, not an idle-cluster rebuild.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.costmodel import CostModel
from repro_torch.core.orchestrator import Orchestrator, OrchestratorConfig
from repro_torch.core.types import H100_SPEC, ClusterSpec, WorkloadType
from repro_torch.models import init_params
from repro_torch.serving.cluster import ClusterRuntime

# Paper-scale archetypes used for *planning*; per-type tiny stand-ins for
# *execution* on the smoke model.
REAL_ARCHETYPES = [WorkloadType(1275, 287), WorkloadType(139, 133),
                   WorkloadType(1181, 1824), WorkloadType(282, 1121)]
REAL_PROMPT_LEN = [14, 6, 12, 8]
REAL_NEW_TOKENS = [4, 4, 8, 6]
# alternate between a short-task-heavy and a long-output-heavy mix so the
# orchestrator has a reason to re-deploy mid-run
REAL_SPAN_RATES = ([5, 300, 2, 3], [40, 10, 60, 40])


@dataclasses.dataclass
class RealSpanOutcome:
    span: int
    plan: object                  # core.orchestrator.SpanPlan
    switch: object                # serving.cluster.SwitchReport
    report: object                # serving.cluster.SpanReport
    predicted_share: np.ndarray   # planner fractions @ rates, normalized
    achieved_share: np.ndarray    # tokens actually served per replica
    observed_rates: np.ndarray    # orchestrator's per-type EWMA after span
    n_requests: int
    seconds: float

    @property
    def share_l1(self) -> float:
        return float(np.abs(self.predicted_share - self.achieved_share).sum())


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def run_real_spans(model: str = "opt-30b", chips: int = 6,
                   n_spans: int = 2, requests_per_span: int = 6,
                   seed: int = 0, shard: bool = False,
                   prefix_cache: bool = True, shared_prefix_len: int = 16,
                   telemetry=None, rebalance: bool = False,
                   disagg: bool = False, device="cuda"
                   ) -> tuple[list[RealSpanOutcome], "object"]:
    """Drive ``n_spans`` orchestrator plans through a real ClusterRuntime.

    Returns the per-span outcomes and the runtime (whose ``results`` hold
    every finished request for parity / completeness checks).

    ``telemetry`` (a ``serving.telemetry.Telemetry``) is threaded into the
    runtime when given: lifecycle events, latency histograms and the
    orchestrator decision audit accumulate there, and the caller can export
    a Chrome trace of the run afterwards.

    ``shared_prefix_len`` > 0 turns the trace into the shared-prefix shape
    real traffic has (system prompts / few-shot templates): every request
    of a type starts with that type's fixed template prefix (page-aligned
    at the runtime's block size), so the prefix cache has something to hit
    and the per-type hit-rate loop into ``plan_span`` is exercised end to
    end.  0 restores fully random prompts.

    ``rebalance=True`` turns on the runtime's live rebalancer (watchdog
    straggler drains, hot-spot relief, priority preemption — see the policy
    section in ``serving.cluster``); the per-span move counters land on
    ``SpanReport.rebalanced`` / ``SpanReport.preempted``.

    ``disagg=True`` lets the planner consider disaggregated prefill/decode
    role splits (``OrchestratorConfig.disaggregate``); when a span plan
    carries roles, the runtime routes new requests to prefill replicas and
    hands first-token-ready contexts to decode replicas
    (``SpanReport.handoffs`` / ``SpanReport.role_util``).

    ``shard=True`` executes each replica's (tp, pp) on a sub-mesh of its
    own chips (``ClusterRuntime(shard=True)``): ``chips`` virtual chips on
    ``device``, per-replica head-sharded pools, switches by
    ``reshard_blocks``; every family, SSM rows moving with their
    requests.

    ``model``'s smoke config runs the engines and its full config is the
    planning profile; the default is the JAX package's, opt-30b.  The fp32
    weights are the port's ``init_params(seed)``, drawn on the CPU and
    moved to ``device``, so the card and the CPU serve the same weights.
    """
    cfg = get_smoke_config(model)
    params = _to(init_params(cfg, seed=seed, dtype=torch.float32,
                             device="cpu"), device)
    cm = CostModel(get_config(model).profile(), hw=H100_SPEC)
    orch = Orchestrator(cm, ClusterSpec(chips, hw=H100_SPEC),
                        OrchestratorConfig(search_patience=8,
                                           disaggregate=disagg))
    runtime = ClusterRuntime(cfg, params, orch, blocks_per_chip=16,
                             seqs_per_chip=1, block_size=8, drain_steps=2,
                             seed=seed, shard=shard,
                             prefix_cache=prefix_cache, telemetry=telemetry,
                             rebalance=rebalance, dtype=torch.float32,
                             device=device)
    rng = np.random.RandomState(seed)
    # one fixed template per type, drawn from a separate stream so toggling
    # the mode doesn't perturb the per-request draws below
    t_rng = np.random.RandomState(seed + 1)
    templates = [t_rng.randint(0, cfg.vocab_size,
                               shared_prefix_len).astype(np.int32)
                 for _ in range(len(REAL_ARCHETYPES))]
    outcomes: list[RealSpanOutcome] = []
    rid = 0
    for s in range(n_spans):
        t0 = time.time()
        rates = REAL_SPAN_RATES[s % len(REAL_SPAN_RATES)]
        ws = [a.with_rate(float(r)) for a, r in zip(REAL_ARCHETYPES, rates)]
        plan = orch.plan_span(ws)
        switch = runtime.apply_plan(plan)
        types = rng.choice(4, size=requests_per_span,
                           p=np.asarray(rates, float) / np.sum(rates))
        for t in types:
            t = int(t)
            prompt = rng.randint(0, cfg.vocab_size,
                                 REAL_PROMPT_LEN[t]).astype(np.int32)
            if shared_prefix_len:
                prompt = np.concatenate([templates[t], prompt])
            runtime.submit(rid, prompt, REAL_NEW_TOKENS[t], type_id=t)
            rid += 1
            runtime.step(); runtime.step()
        # do NOT run to idle mid-run: later requests stay in flight across
        # the span boundary so the next apply_plan exercises the live
        # drain/migrate switch path; only the last span flushes everything
        if s == n_spans - 1:
            runtime.run_until_idle()
        report = runtime.finish_span()
        frac = np.array(plan.fractions)
        # score in *token* shares on both sides: the plan's request fractions
        # are weighted by each type's decode length so the predicted share is
        # comparable to the tokens the replicas actually emitted (carryover
        # from the previous span adds a little noise — this is a smoke
        # metric, not a benchmark)
        load = frac @ (np.asarray(rates, float)
                       * np.asarray(REAL_NEW_TOKENS, float))
        predicted = load / max(load.sum(), 1e-9)
        achieved = (np.asarray(report.tokens, float)
                    / max(sum(report.tokens), 1))
        outcomes.append(RealSpanOutcome(
            s, plan, switch, report, predicted, achieved,
            np.array(orch.observed_rates), requests_per_span,
            time.time() - t0))
    return outcomes, runtime
