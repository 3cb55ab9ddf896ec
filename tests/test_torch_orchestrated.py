"""The orchestrated path on the port: ``Orchestrator.plan_span`` ->
``ClusterRuntime.apply_plan`` with requests in flight, against the JAX
package's planner and runtime.

Each scenario is a twin of one of the JAX package's orchestrated tests
(``test_cluster.py``'s switch and repair cases, ``test_faults.py``'s chaos
case, ``test_migration.py``'s handoff-friendly planning and
``test_telemetry.py``'s audited trace), written once against a package
namespace and run on both packages: the plans, streams, ``SwitchReport``s,
``SpanReport``s and the runtime's state must be equal, and the JAX test's
own checks must hold on the port.  The planner plans for opt-30b (paper
scale, H100 spec); the engines serve yi-9b smoke in fp32 on the CPU with
JAX's weights.  Each JAX run is cached per module."""
import functools
import json
import types

import numpy as np
import pytest

import repro.configs as jconfigs
import repro.core.costmodel as jcost
import repro.core.orchestrator as jorch
import repro.core.types as jtypes
import repro.serving.telemetry as jtel
import repro_torch.configs as tconfigs
import repro_torch.core.costmodel as tcost
import repro_torch.core.orchestrator as torch_orch
import repro_torch.core.types as ttypes
import repro_torch.serving.telemetry as ttel
from torch_cluster_twins import cluster_state, events, package, plain

ARCH = [(1275, 287), (139, 133), (1181, 1824), (282, 1121)]
PLAN_FIELDS = ("deployment", "placed", "fractions", "throughput",
               "switch_seconds", "reload_seconds", "changed_replicas",
               "kv_migration_seconds")


def planner(name):
    """One package's planner entry points."""
    if name == "jax":
        return types.SimpleNamespace(
            get_config=jconfigs.get_config, CostModel=jcost.CostModel,
            Orchestrator=jorch.Orchestrator,
            OrchestratorConfig=jorch.OrchestratorConfig,
            ClusterSpec=jtypes.ClusterSpec, H100_SPEC=jtypes.H100_SPEC,
            WorkloadType=jtypes.WorkloadType, tel=jtel)
    return types.SimpleNamespace(
        get_config=tconfigs.get_config, CostModel=tcost.CostModel,
        Orchestrator=torch_orch.Orchestrator,
        OrchestratorConfig=torch_orch.OrchestratorConfig,
        ClusterSpec=ttypes.ClusterSpec, H100_SPEC=ttypes.H100_SPEC,
        WorkloadType=ttypes.WorkloadType, tel=ttel)


def ws(pl, rates):
    return [pl.WorkloadType(i, o, float(r)) for (i, o), r in zip(ARCH, rates)]


def orchestrator(pl, chips, patience=10):
    cm = pl.CostModel(pl.get_config("opt-30b").profile(), hw=pl.H100_SPEC)
    return pl.Orchestrator(cm, pl.ClusterSpec(chips, hw=pl.H100_SPEC),
                           pl.OrchestratorConfig(search_patience=patience))


def plan_fields(plan) -> dict:
    return {f: plain(getattr(plan, f)) for f in PLAN_FIELDS}


def orch_state(o) -> dict:
    return plain({"current": o.current, "placed": o.placed,
                  "health": o.health, "observed": o.observed_rates,
                  "prefix": o.prefix_hit_rate, "inflight": o.inflight_lens,
                  "shared": o.inflight_shared_pool,
                  "churn": o.rebalance_churn, "chips": o.cluster.chips})


def runtime(pkg, orch, **kw):
    return pkg.ClusterRuntime(pkg.cfg, pkg.params, orch, **pkg.kw, **kw)


def reference_tokens(pkg, jobs, max_seqs=8):
    """One uninterrupted engine's greedy streams for ``jobs``."""
    ref = pkg.engine(num_blocks=256, block_size=8, max_seqs=max_seqs)
    for r, (prompt, n) in jobs.items():
        ref.submit(r, prompt, n)
    return {r.rid: list(r.generated) for r in ref.run_to_completion()}


# --------------------------------------------------------------------------
# the scenarios, one package at a time
# --------------------------------------------------------------------------


def e2e_switch(name):
    """``test_cluster.py::test_cluster_e2e_orchestrated_switch_token_parity``:
    two spans, the second flips the mix and switches with everything in
    flight (``drain_steps=0``)."""
    pkg, pl = package(name), planner(name)
    orch = orchestrator(pl, 6)
    rt = runtime(pkg, orch, blocks_per_chip=16, seqs_per_chip=1,
                 block_size=8, drain_steps=0)
    rng = np.random.RandomState(0)
    jobs, plans, switches, spans = {}, [], [], []
    rid = 0
    for rates in ([5, 300, 2, 3], [40, 10, 60, 40]):
        plan = orch.plan_span(ws(pl, rates))
        plans.append(plan_fields(plan))
        switches.append(plain(rt.apply_plan(plan)))
        for _ in range(6):
            t = int(rng.randint(0, 4))
            prompt = rng.randint(0, pkg.cfg.vocab_size,
                                 6 + 2 * t).astype(np.int32)
            jobs[rid] = (prompt, 8 + t)
            rt.submit(rid, prompt, 8 + t, type_id=t)
            rid += 1
        for _ in range(4):
            rt.step()
        spans.append(plain(rt.finish_span()))
    rt.run_until_idle()
    return dict(plans=plans, switches=switches, spans=spans,
                state=cluster_state(rt), orch=orch_state(orch),
                reference=reference_tokens(pkg, jobs), n=rid)


def repair(name):
    """``test_cluster.py::test_repair_replica_rejoins_planning_budget``."""
    pkg, pl = package(name), planner(name)
    orch = orchestrator(pl, 6)
    plan = orch.plan_span(ws(pl, [5, 300, 2, 3]))
    rt = runtime(pkg, orch, blocks_per_chip=16, seqs_per_chip=2,
                 block_size=8, drain_steps=1)
    out = dict(plan=plan_fields(plan), switch=plain(rt.apply_plan(plan)))
    n_live = len(rt.replicas)
    rt.fail_replica(0, reason="test kill")
    out["failed_span"] = plain(rt.finish_span())
    out["after_fail"] = orch_state(orch)
    out["lost"] = (rt.lost_chips, rt.replicas[0].rc.chips, n_live)
    rt.repair_replica(0)
    out["after_repair"] = orch_state(orch)
    out["repaired"] = (rt.repaired_replicas, rt.lost_chips,
                       rt.replicas[0].dead)
    rt.repair_replica(0)                  # a live replica: a no-op
    out["again"] = (rt.repaired_replicas, rt.lost_chips)
    for rid in range(4):
        rt.submit(rid, np.arange(8, dtype=np.int32), 4)
    rt.run_until_idle()
    out["plan2"] = plan_fields(orch.plan_span(ws(pl, [40, 10, 60, 40])))
    out["state"] = cluster_state(rt)
    out["total_chips"] = rt.total_chips
    out["live_rcs"] = plain([h.rc for h in rt.replicas])
    return out


def chaos(name):
    """``test_faults.py::test_chaos_parity_crash_stall_failed_switch``: a
    stall and a crash on the replica that got the first request, and the
    span-1 switch failing mid-migration (rolled back)."""
    pkg, pl = package(name), planner(name)
    orch = orchestrator(pl, 6)
    plan0 = orch.plan_span(ws(pl, [5, 300, 2, 3]))
    plans = [plan_fields(plan0)]
    rt = runtime(pkg, orch, blocks_per_chip=16, seqs_per_chip=2,
                 block_size=8, drain_steps=0)
    rt.apply_plan(plan0)
    rng = np.random.RandomState(0)
    jobs, span_reports = {}, []
    switch_reports = [plain(rt.switch_reports[-1])]
    faults, rid = None, 0
    for span, rates in enumerate(([5, 300, 2, 3], [40, 10, 60, 40])):
        if span > 0:
            plan = orch.plan_span(ws(pl, rates))
            plans.append(plan_fields(plan))
            switch_reports.append(plain(rt.apply_plan(plan)))
        for _ in range(6):
            t = int(rng.randint(0, 4))
            prompt = rng.randint(0, pkg.cfg.vocab_size,
                                 6 + 2 * t).astype(np.int32)
            jobs[rid] = (prompt, 8 + t)
            k = rt.submit(rid, prompt, 8 + t, type_id=t)
            if faults is None:
                faults = pkg.FaultPlan([
                    pkg.FaultSpec("stall", 3, replica=k, steps=3),
                    pkg.FaultSpec("crash", 6, replica=k),
                    pkg.FaultSpec("switch_migrate", 2)])
                rt.faults = faults
            rid += 1
            rt.step()
            rt.step()
        if span == 1:
            rt.run_until_idle()
        span_reports.append(plain(rt.finish_span()))
    return dict(plans=plans, switches=switch_reports, spans=span_reports,
                state=cluster_state(rt), orch=orch_state(orch),
                crashes=faults.fired("crash"), surviving=rt.surviving_chips,
                total_chips=rt.total_chips, jobs={r: n for r, (_, n)
                                                  in jobs.items()},
                reference=reference_tokens(pkg, jobs, max_seqs=12), n=rid)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 0.125            # deterministic, strictly increasing
        return self.t


def audited_trace(name):
    """``test_telemetry.py::test_orchestrated_switch_exports_valid_trace``
    on a clock that advances on every read: the event stream, the
    exported trace's counts and the decision audit."""
    pkg, pl = package(name), planner(name)
    orch = orchestrator(pl, 6)
    tm = pl.tel.Telemetry(clock=FakeClock())
    rt = runtime(pkg, orch, blocks_per_chip=16, seqs_per_chip=1,
                 block_size=8, drain_steps=0, telemetry=tm)
    rng = np.random.RandomState(0)
    rid, plans = 0, []
    for rates in ([5, 300, 2, 3], [40, 10, 60, 40]):
        plan = orch.plan_span(ws(pl, rates))
        plans.append(plan_fields(plan))
        rt.apply_plan(plan)
        for _ in range(6):
            t = int(rng.randint(0, 4))
            prompt = rng.randint(0, pkg.cfg.vocab_size,
                                 6 + 2 * t).astype(np.int32)
            rt.submit(rid, prompt, 8 + t, type_id=t)
            rid += 1
        for _ in range(4):
            rt.step()
        rt.finish_span()
    rt.run_until_idle()
    obj = json.loads(json.dumps(pl.tel.export_chrome_trace(tm)))
    return dict(plans=plans, events=events(tm),
                counts=pl.tel.validate_chrome_trace(obj),
                tids=sorted({e["tid"] for e in obj["traceEvents"]
                             if e["ph"] != "M"}),
                named=sorted({e["tid"] for e in obj["traceEvents"]
                              if e["ph"] == "M"}),
                audit=plain(tm.audit.records),
                calibration=plain(tm.audit.calibration_error()),
                hist={k: tm.metrics.histograms[k].count
                      for k in ("ttft_s", "tpot_s", "queue_delay_s")},
                state=cluster_state(rt), n=rid)


SCENARIOS = {"e2e_switch": e2e_switch, "repair": repair, "chaos": chaos,
             "audited_trace": audited_trace}


@functools.lru_cache(maxsize=None)
def run(scenario, name):
    return SCENARIOS[scenario](name)


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_scenario_equals_jax(scenario):
    assert run(scenario, "torch") == run(scenario, "jax")


def test_e2e_orchestrated_switch_on_the_port():
    got = run("e2e_switch", "torch")
    deps = [p["deployment"] for p in got["plans"]]
    assert deps[0] != deps[1]
    assert len(set(deps[1]["replicas"])) >= 2, "not heterogeneous"
    switch = got["switches"][1]
    assert switch["changed"], "no replica was rebuilt"
    assert switch["migrated"] >= 1, "no in-flight request was migrated"
    tokens = got["state"]["tokens"]
    assert sorted(tokens) == list(range(got["n"]))
    assert tokens == got["reference"]


def test_repair_rejoins_planning_budget_on_the_port():
    got = run("repair", "torch")
    lost, chips0, n_live = got["lost"]
    assert len(got["plan"]["deployment"]["replicas"]) >= 2
    assert lost == chips0
    assert got["after_fail"]["chips"] == got["total_chips"] - lost
    assert len(got["after_fail"]["current"]["replicas"]) == n_live - 1
    assert got["repaired"] == ([0], 0, False)
    after = got["after_repair"]
    assert after["chips"] == got["total_chips"]
    assert list(after["current"]["replicas"]) == got["live_rcs"]
    assert after["health"] is None or (len(after["health"]) == n_live
                                       and after["health"][0] == 1.0)
    assert got["again"] == ([0], 0)
    assert set(got["state"]["tokens"]) == set(range(4))
    assert got["plan2"]["deployment"]["replicas"]
    assert sum(t * p for t, p, _ in got["plan2"]["deployment"]["replicas"]) \
        <= got["total_chips"]


def test_chaos_crash_stall_failed_switch_on_the_port():
    got = run("chaos", "torch")
    assert got["crashes"] == 1
    dead = [s for s in got["spans"] if s["dead_replicas"]]
    assert dead, "no span accounted the dead replica"
    rec = dead[0]["recovery"]
    migrated = rec["handoff"] + rec["copied"] + rec["reprefilled"]
    assert migrated + rec["requeued"] + rec["dropped"] >= 1
    rolled = [s for s in got["switches"] if s["rolled_back"]]
    assert rolled and "injected migration failure" in rolled[0]["failure"]
    state = got["state"]
    done, shed = set(state["tokens"]), set(state["all_shed_rids"])
    assert shed | done == set(range(got["n"]))
    for r in done:
        assert state["tokens"][r] == got["reference"][r], r
        assert len(state["tokens"][r]) == got["jobs"][r]
    assert got["orch"]["chips"] == got["surviving"] < got["total_chips"]


def test_audited_trace_on_the_port():
    got = run("audited_trace", "torch")
    kinds = {e[0] for e in got["events"]}
    assert "migrate" in kinds
    assert "switch_prepare" in kinds and "switch_commit" in kinds
    counts = got["counts"]
    assert len(set(got["tids"]) - {ttel.ORCH_TID}) >= 2
    assert ttel.ORCH_TID in got["tids"]
    assert set(got["tids"]) <= set(got["named"])
    assert counts["flows"] >= 1 and counts["be_pairs"] >= 2
    assert counts["slices"] >= got["n"]
    assert sum(1 for r in got["audit"] if r["realized_share"]) == 2
    assert np.isfinite(got["calibration"])
    assert got["hist"]["ttft_s"] == got["hist"]["tpot_s"] == got["n"]
    assert got["hist"]["queue_delay_s"] >= got["n"]


@pytest.mark.parametrize("shared", [None, True, False])
def test_orchestrator_prefers_handoff_friendly_switches(shared):
    """``test_migration.py``'s case in both packages: with heavy in-flight
    contexts and no shared pool the KV stall holds the deployment; with
    page handoff (or nothing observed) the planner switches."""
    r1, r2 = [5, 300, 2, 3], [40, 10, 60, 40]
    lens = [8000] * 1000
    out = {}
    for name in ("jax", "torch"):
        pl = planner(name)
        o = orchestrator(pl, 6)
        o.plan_span(ws(pl, r1))
        if shared is not None:
            o.observe_inflight(lens, shared_pool=shared)
        kv = o.switch_kv_seconds()
        out[name] = (plan_fields(o.plan_span(ws(pl, r2))), kv,
                     orch_state(o))
    assert out["torch"] == out["jax"]
    plan, kv, _ = out["torch"]
    if shared is False:
        assert kv > 10.0
        assert not plan["changed_replicas"]
    else:
        assert plan["changed_replicas"]
        assert plan["kv_migration_seconds"] == 0.0
