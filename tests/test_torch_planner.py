"""The port's planner against the JAX package's, exactly.

The cost model, the flow-network solvers, the workload assignment, the
deployment searches, the switch planners and the orchestrator are pure
Python and numpy copies in both packages, so every number they produce is
held equal (``==``, not a tolerance) on the same inputs, the H100 spec
passed explicitly on both sides.  ``SpanPlan``s are compared field by
field, all but the wall-clock ``search_time``."""
import dataclasses
import random

import numpy as np
import pytest

import repro.configs as jconfigs
import repro.core.assignment as jassign
import repro.core.costmodel as jcost
import repro.core.deployment as jdep
import repro.core.flownet as jflow
import repro.core.orchestrator as jorch
import repro.core.switching as jswitch
import repro.core.types as jtypes
import repro_torch.configs as tconfigs
import repro_torch.core.assignment as tassign
import repro_torch.core.costmodel as tcost
import repro_torch.core.deployment as tdep
import repro_torch.core.flownet as tflow
import repro_torch.core.orchestrator as torch_orch
import repro_torch.core.switching as tswitch
import repro_torch.core.types as ttypes
from torch_cluster_twins import plain

ARCH = [(1275, 287), (139, 133), (1181, 1824), (282, 1121)]
PLAN_FIELDS = ("deployment", "placed", "fractions", "throughput",
               "switch_seconds", "reload_seconds", "changed_replicas",
               "kv_migration_seconds")


def ws(types, rates, cached=None):
    cached = cached or [0.0] * len(rates)
    return [types.WorkloadType(i, o, float(r), c)
            for (i, o), r, c in zip(ARCH, rates, cached)]


def cost_models(arch):
    return (jcost.CostModel(jconfigs.get_config(arch).profile(),
                            hw=jtypes.H100_SPEC),
            tcost.CostModel(tconfigs.get_config(arch).profile(),
                            hw=ttypes.H100_SPEC))


def rc(types, tp, pp=1, role="mixed"):
    return types.ReplicaConfig(tp, pp, role)


def dep(types, shapes):
    return types.Deployment(tuple(rc(types, *s) for s in shapes))


def plan_fields(plan) -> dict:
    return {f: plain(getattr(plan, f)) for f in PLAN_FIELDS}


# --------------------------------------------------------------------------
# types, configs and the cost model
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch", tconfigs.ARCHS)
def test_profile_equals_jax(arch):
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert (dataclasses.asdict(tcfg.profile())
            == dataclasses.asdict(jcfg.profile()))
    assert tcfg.param_count() == jcfg.param_count()
    assert (tcfg.reduced().profile().param_count
            == jcfg.reduced().profile().param_count)


def test_paper_models_registered_and_served_as_documented():
    from repro_torch.models.model import check_supported
    for arch in ("llama-30b", "llama2-70b"):
        check_supported(tconfigs.get_config(arch))
    for arch in ("opt-30b", "opt-66b"):
        with pytest.raises(NotImplementedError, match="Queue A item 5"):
            check_supported(tconfigs.get_config(arch))


def test_hardware_and_cluster_specs():
    assert (dataclasses.asdict(ttypes.H100_SPEC)
            == dataclasses.asdict(jtypes.H100_SPEC))
    assert ttypes.ClusterSpec(6).hw == ttypes.H100_SPEC
    assert tcost.CostModel(tconfigs.get_config("yi-9b").profile()).hw \
        == ttypes.H100_SPEC
    for chips in (1, 6, 9, 17, 40):
        assert (ttypes.ClusterSpec(chips).pods
                == jtypes.ClusterSpec(chips, hw=jtypes.H100_SPEC).pods)
        for chip in range(chips):
            assert (ttypes.H100_SPEC.pod_of(chip), ttypes.H100_SPEC.host_of(
                chip)) == (jtypes.H100_SPEC.pod_of(chip),
                           jtypes.H100_SPEC.host_of(chip))


@pytest.mark.parametrize("chips", [1, 4, 6, 8, 12, 16, 24])
def test_valid_strategies_and_fractions(chips):
    for kw in ({}, dict(max_tp=8, max_pp=4), dict(max_tp=2, max_pp=8)):
        assert (plain(ttypes.valid_strategies(chips, **kw))
                == plain(jtypes.valid_strategies(chips, **kw)))
    rng = np.random.RandomState(chips)
    x = rng.uniform(0, 10, (3, 4)).tolist()
    rates = [5.0, 0.0, 12.5, 3.0]
    assert (ttypes.assignment_as_fractions(x, rates)
            == jtypes.assignment_as_fractions(x, rates))


COST_ARCHS = ["opt-30b", "llama2-70b", "yi-9b", "mamba2-370m",
              "hymba-1.5b"]


@pytest.mark.parametrize("arch", COST_ARCHS)
def test_cost_model_exact(arch):
    jcm, tcm = cost_models(arch)
    assert tcm.reload_seconds() == jcm.reload_seconds()
    assert tcm.min_chips() == jcm.min_chips()
    for cached in (0.0, 0.4):
        for (i, o) in ARCH:
            jw = jtypes.WorkloadType(i, o, 10.0, cached)
            tw = ttypes.WorkloadType(i, o, 10.0, cached)
            assert tcm.kv_hop_seconds(tw) == jcm.kv_hop_seconds(jw)
            for role in ttypes.REPLICA_ROLES:
                for jr, tr in zip(jtypes.valid_strategies(8),
                                  ttypes.valid_strategies(8)):
                    jr, tr = jr.with_role(role), tr.with_role(role)
                    assert (tcm.measure_prefill(tr, i)
                            == jcm.measure_prefill(jr, i))
                    for batch in (1, 16):
                        assert (tcm.measure_decode_step(tr, batch, i + o)
                                == jcm.measure_decode_step(jr, batch, i + o))
                    assert tcm.kv_budget_bytes(tr) == jcm.kv_budget_bytes(jr)
                    assert tcm.fits(tr) == jcm.fits(jr)
                    assert (tcm.max_concurrency(tr, tw)
                            == jcm.max_concurrency(jr, jw))
                    assert (dataclasses.asdict(tcm.replica_perf(tr, tw))
                            == dataclasses.asdict(jcm.replica_perf(jr, jw)))
                    assert tcm.capacity(tr, tw) == jcm.capacity(jr, jw)
                    assert (tcm.edge_capacity(tr, tw)
                            == jcm.edge_capacity(jr, jw))


@pytest.mark.parametrize("shapes", [
    [(2,), (2,), (2,)],
    [(1, 2), (4,)],
    [(2, 1, "prefill"), (2, 1, "decode"), (2,)],
    [(4, 1, "prefill"), (2, 1, "decode")],
])
def test_profile_capacities_exact(shapes):
    jcm, tcm = cost_models("llama2-70b")
    jrs = [rc(jtypes, *s) for s in shapes]
    trs = [rc(ttypes, *s) for s in shapes]
    for cached in (None, [0.5, 0.0, 0.25, 0.9]):
        got = tcost.profile_capacities(tcm, trs, ws(ttypes, [1] * 4, cached))
        want = jcost.profile_capacities(jcm, jrs, ws(jtypes, [1] * 4, cached))
        assert got == want


# --------------------------------------------------------------------------
# the flow network (``tests/test_flownet.py``'s cases)
# --------------------------------------------------------------------------


def random_graph(rng, n_max=10, e_max=25, c_max=20):
    n = rng.randint(2, n_max)
    edges = []
    for _ in range(rng.randint(0, e_max)):
        u, v = rng.randrange(n), rng.randrange(n)
        if u != v:
            edges.append((u, v, rng.randint(0, c_max)))
    return n, edges


@pytest.mark.parametrize("seed", [1, 2])
def test_maxflow_solvers_equal(seed):
    rng = random.Random(seed)
    for _ in range(150):
        n, edges = random_graph(rng)
        assert (tflow.maxflow_preflow_push(n, edges, 0, n - 1)
                == jflow.maxflow_preflow_push(n, edges, 0, n - 1))
        assert (tflow.maxflow_edmonds_karp(n, edges, 0, n - 1)
                == jflow.maxflow_edmonds_karp(n, edges, 0, n - 1))


@pytest.mark.parametrize("lp", [
    ([1, 1], [[1, 0], [0, 1], [1, 1]], [2, 3, 4]),
    ([1, 1, 1], [[1, 1, 0], [0, 1, 1], [1, 0, 1], [1, 1, 1]],
     [1, 1, 1, 1.5]),
    ([3, 2, 4], [[1, 2, 1], [2, 0, 3], [0, 1, 1]], [10, 12, 5]),
])
def test_simplex_equal(lp):
    assert tflow.simplex_maximize(*lp) == jflow.simplex_maximize(*lp)


def _flow_cases():
    cases = [([100.0], [[30.0], [50.0]]),
             ([10, 10], [[80, 50], [40, 40]]),
             ([100.0, 50.0], [[10 * 13.67, 5 * 13.67], [5 * 13.67, 3 * 13.67],
                              [5 * 13.67, 3 * 13.67]])]
    for seed in range(12):
        rng = np.random.RandomState(seed)
        K, J = 1 + seed % 4, 1 + (seed // 4) % 4
        rates = rng.uniform(0, 100, J).tolist()
        n = rng.uniform(0, 80, (K, J))
        n[rng.rand(K, J) < 0.2] = 0.0
        cases.append((rates, n.tolist()))
    return cases


@pytest.mark.parametrize("rates,n", _flow_cases())
def test_workload_flow_network_equal(rates, n):
    jnet, tnet = (jflow.WorkloadFlowNetwork(rates, n),
                  tflow.WorkloadFlowNetwork(rates, n))
    assert (tnet.M, tnet.m_units) == (jnet.M, jnet.m_units)
    jsol, tsol = jnet.solve(), tnet.solve()
    assert plain(tsol) == plain(jsol)
    if len(n) >= 2:
        assert plain(tnet.balance(tsol)) == plain(jnet.balance(jsol))


# --------------------------------------------------------------------------
# assignment, deployment search and switch planning
# --------------------------------------------------------------------------


@pytest.mark.parametrize("rates", [[10, 10, 10, 10], [1000] * 4,
                                   [5, 300, 2, 3], [40, 10, 60, 40]])
def test_assign_workloads_equal(rates):
    jcm, tcm = cost_models("opt-30b")
    shapes = [(8,), (4, 2), (2, 2, "prefill"), (2, 1, "decode")]
    for scale in (None, [1.0, 0.3, 0.8, 1.0]):
        for balance in (True, False):
            got = tassign.assign_workloads(
                tcm, dep(ttypes, shapes), ws(ttypes, rates),
                capacity_scale=scale, balance=balance)
            want = jassign.assign_workloads(
                jcm, dep(jtypes, shapes), ws(jtypes, rates),
                capacity_scale=scale, balance=balance)
            assert plain(got.solution) == plain(want.solution)
            assert got.fractions == want.fractions
            assert (got.n_cap, got.e_cap) == (want.n_cap, want.e_cap)
            assert got.latency_proxy() == want.latency_proxy()


@pytest.mark.parametrize("arch,chips,rates,seed", [
    ("opt-30b", 16, [500] * 4, 3),
    ("opt-30b", 8, [2000] * 4, 0),
    ("opt-30b", 16, [50, 600, 30, 60], 0),
    ("llama2-70b", 6, [5, 300, 2, 3], 0),
    ("llama2-70b", 6, [40, 10, 60, 40], 0),
    ("yi-9b", 4, [40, 10, 60, 40], 1),
])
def test_flow_guided_search_equal(arch, chips, rates, seed):
    jcm, tcm = cost_models(arch)
    kw = dict(max_tp=8, max_pp=4, patience=8, seed=seed)
    got = tdep.flow_guided_search(tcm, chips, ws(ttypes, rates), **kw)
    want = jdep.flow_guided_search(jcm, chips, ws(jtypes, rates), **kw)
    assert plain(got.deployment) == plain(want.deployment)
    assert plain(got.assignment.solution) == plain(want.assignment.solution)
    assert (got.evaluations, got.iterations) == (want.evaluations,
                                                 want.iterations)
    # warm-started from a heterogeneous deployment of the same chips
    init = [(chips // 2,), (chips - chips // 2,)]
    got = tdep.flow_guided_search(tcm, chips, ws(ttypes, rates),
                                  initial=dep(ttypes, init), **kw)
    want = jdep.flow_guided_search(jcm, chips, ws(jtypes, rates),
                                   initial=dep(jtypes, init), **kw)
    assert plain(got.deployment) == plain(want.deployment)
    assert got.throughput == want.throughput


@pytest.mark.parametrize("shapes,rates", [
    ([(2,), (2,), (2,)], [5, 300, 2, 3]),
    ([(2,), (2,), (2,)], [40, 10, 60, 40]),
    ([(4,), (4,)], [1000, 50, 800, 20]),
    ([(2, 2), (4,), (2,)], [300, 300, 300, 300]),
])
def test_role_split_search_equal(shapes, rates):
    jcm, tcm = cost_models("llama2-70b")
    got = tdep.role_split_search(tcm, dep(ttypes, shapes), ws(ttypes, rates))
    want = jdep.role_split_search(jcm, dep(jtypes, shapes),
                                  ws(jtypes, rates))
    assert plain(got) == plain(want)


def test_exhaustive_search_and_enumeration_equal():
    jcm, tcm = cost_models("opt-30b")
    assert (plain(tdep.enumerate_deployments(16, tcm.min_chips(), max_tp=8,
                                             max_pp=4))
            == plain(jdep.enumerate_deployments(16, jcm.min_chips(),
                                                max_tp=8, max_pp=4)))
    assert (plain(tdep.uniform_initial(tcm, 16, max_tp=8, max_pp=4))
            == plain(jdep.uniform_initial(jcm, 16, max_tp=8, max_pp=4)))
    got = tdep.exhaustive_search(tcm, 8, ws(ttypes, [2000] * 4), max_tp=8,
                                 max_pp=4)
    want = jdep.exhaustive_search(jcm, 8, ws(jtypes, [2000] * 4), max_tp=8,
                                  max_pp=4)
    assert plain(got.deployment) == plain(want.deployment)
    assert got.throughput == want.throughput


SWITCH_CASES = [
    ([(8, 2)], [(4, 2), (4, 2)]),
    ([(2, 1)] * 8, [(8, 1), (8, 1)]),
    ([(8, 1), (4, 1), (4, 1)], [(4, 2), (4, 2)]),
    ([(3, 2), (2, 1), (8, 1)], [(8, 2)]),       # non-power-of-two TP=3
    ([(2, 1), (2, 1), (2, 1)], [(1, 2), (4, 1)]),
]


@pytest.mark.parametrize("src,dst", SWITCH_CASES)
def test_plan_switch_equal(src, dst):
    jcm, tcm = cost_models("opt-66b")
    chips = max(sum(t * p for t, p in src), sum(t * p for t, p in dst))
    jcl = jtypes.ClusterSpec(chips, hw=jtypes.H100_SPEC)
    tcl = ttypes.ClusterSpec(chips, hw=ttypes.H100_SPEC)
    jps = jswitch.place_deployment(dep(jtypes, src), jcl)
    tps = tswitch.place_deployment(dep(ttypes, src), tcl)
    jpd = jswitch.place_deployment(dep(jtypes, dst), jcl)
    tpd = tswitch.place_deployment(dep(ttypes, dst), tcl)
    assert plain(tps) == plain(jps) and plain(tpd) == plain(jpd)
    got = tswitch.plan_switch(tps, tpd, tcm, ttypes.H100_SPEC)
    want = jswitch.plan_switch(jps, jpd, jcm, jtypes.H100_SPEC)
    assert plain(got) == plain(want)
    assert (got.estimate_seconds(ttypes.H100_SPEC)
            == want.estimate_seconds(jtypes.H100_SPEC))


@pytest.mark.parametrize("shared", [False, True])
def test_plan_kv_migration_equal(shared):
    jcm, tcm = cost_models("llama2-70b")
    lens = {rid: n for rid, n in enumerate([17, 2047, 2048, 4000, 9000, 1])}
    for threshold in (0, 2048):
        got = tswitch.plan_kv_migration(tcm, lens, threshold,
                                        shared_pool=shared)
        want = jswitch.plan_kv_migration(jcm, lens, threshold,
                                         shared_pool=shared)
        assert plain(got) == plain(want)
        for intra in (True, False):
            assert (got.estimate_seconds(ttypes.H100_SPEC, intra)
                    == want.estimate_seconds(jtypes.H100_SPEC, intra))


# --------------------------------------------------------------------------
# the orchestrator (``tests/test_orchestrator.py``'s scenarios)
# --------------------------------------------------------------------------


def orchestrators(arch="opt-30b", chips=16, **cfg):
    jcm, tcm = cost_models(arch)
    return (jorch.Orchestrator(jcm, jtypes.ClusterSpec(chips,
                                                       hw=jtypes.H100_SPEC),
                               jorch.OrchestratorConfig(**cfg)),
            torch_orch.Orchestrator(tcm, ttypes.ClusterSpec(
                chips, hw=ttypes.H100_SPEC),
                torch_orch.OrchestratorConfig(**cfg)))


def orch_state(o) -> dict:
    return plain({"current": o.current, "placed": o.placed,
                  "health": o.health, "observed": o.observed_rates,
                  "prefix": o.prefix_hit_rate, "inflight": o.inflight_lens,
                  "shared": o.inflight_shared_pool,
                  "churn": o.rebalance_churn, "chips": o.cluster.chips})


def both(orchs, step):
    """Run ``step(orchestrator, types)`` on the JAX and the port
    orchestrator; the results and the orchestrators' states must be
    equal.  Returns the port's result."""
    want = step(orchs[0], jtypes)
    got = step(orchs[1], ttypes)
    if hasattr(got, "deployment"):
        assert plan_fields(got) == plan_fields(want)
    else:
        assert plain(got) == plain(want)
    assert orch_state(orchs[1]) == orch_state(orchs[0])
    return got


def plan(rates, **kw):
    return lambda o, types: o.plan_span(ws(types, rates), **kw)


SCENARIOS = {
    "first_span": [plan([50, 600, 30, 60])],
    "stable": [plan([50, 600, 30, 60]), plan([52, 590, 31, 62])],
    "switch": [plan([50, 2000, 30, 60]), plan([40, 60, 1500, 900])],
    "failure": [plan([50, 600, 30, 60]),
                lambda o, t: o.on_cluster_change(12, ws(t,
                                                        [50, 600, 30, 60]))],
    "elastic_grow": [plan([50, 600, 30, 60]),
                     lambda o, t: o.on_cluster_change(24, ws(
                         t, [50, 600, 30, 60]))],
    "straggler_health": [
        plan([100, 3000, 200, 300]),
        lambda o, t: o.observe_health([0.2] + [1.0] * (o.current.dp - 1)),
        plan([100, 3000, 200, 300]),
        lambda o, t: o.observe_health([0.5] * o.current.dp),
        plan([100, 3000, 200, 300])],
    "feedback": [
        plan([50, 600, 30, 60]),
        lambda o, t: o.observe_rates([40, 500, 20, 80]),
        lambda o, t: o.observe_rates([60, 700, 40, 50]),
        lambda o, t: o.observe_prefix_hits([0.5, float("nan"), 0.2, 0.9]),
        lambda o, t: o.observe_prefix_hits([0.1, 0.3, float("nan"), 0.8]),
        lambda o, t: o.observe_rebalance(7),
        lambda o, t: o.observe_inflight([3000, 9000, 12], shared_pool=False),
        lambda o, t: o.switch_kv_seconds(),
        lambda o, t: o.blended_workloads(ws(t, [50, 600, 30, 60]),
                                         trust=0.3),
        plan([40, 60, 1500, 900]),
        plan([40, 60, 1500, 900], force=True)],
    "failures_rejoin_rollback": [
        plan([100, 3000, 200, 300]),
        lambda o, t: o.observe_health([0.6] * o.current.dp),
        lambda o, t: o.observe_failures([0], 16 - o.current.replicas[0].chips),
        plan([100, 3000, 200, 300]),
        # the dead replica's chips come back as one TP group
        lambda o, t: o.observe_rejoin(
            (rc(t, 16 - o.cluster.chips),) + o.current.replicas, 16, 0),
        lambda o, t: o.on_switch_rollback((rc(t, 8), rc(t, 8))),
        plan([100, 3000, 200, 300]),
        lambda o, t: o.on_switch_rollback(())],
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_orchestrator_scenario_equal(name):
    orchs = orchestrators()
    for step in SCENARIOS[name]:
        both(orchs, step)


def test_orchestrator_disaggregate_equal():
    orchs = orchestrators("llama2-70b", 8, disaggregate=True,
                          search_patience=8)
    plans = [both(orchs, plan(r)) for r in
             ([5, 300, 2, 3], [40, 10, 60, 40], [1000, 50, 800, 20])]
    assert any(r.role != "mixed" for p in plans
               for r in p.deployment.replicas), \
        "the scenario must split roles somewhere"


def test_llama2_70b_plans_switch_every_span():
    """The orchestrated path's planning model: on 6 chips the planner
    switches every span of the alternating mix, in both packages."""
    orchs = orchestrators("llama2-70b", 6, search_patience=8)
    plans = [both(orchs, plan(r)) for r in
             ([5, 300, 2, 3], [40, 10, 60, 40], [5, 300, 2, 3])]
    assert [str(p.deployment) for p in plans] == [
        "DP=3 [(TP=2), (TP=2), (TP=2)]", "DP=2 [(TP=1, PP=2), (TP=4)]",
        "DP=2 [(TP=1, PP=3), (TP=1, PP=3)]"]
    assert all(p.changed_replicas for p in plans)


class _Audit:
    def __init__(self):
        self.calls = []

    def record_plan(self, plan, workloads, **kw):
        self.calls.append((plan_fields(plan), plain(workloads), plain(kw)))


def test_orchestrator_audit_sink_equal():
    orchs = orchestrators("llama2-70b", 6, search_patience=8)
    for o in orchs:
        o.audit = _Audit()
    for rates in ([5, 300, 2, 3], [40, 10, 60, 40]):
        both(orchs, plan(rates))
    both(orchs, lambda o, t: o.observe_prefix_hits([0.5, 0.1, 0.0, 0.2]))
    both(orchs, plan([5, 300, 2, 3]))
    assert orchs[1].audit.calls == orchs[0].audit.calls
    assert len(orchs[1].audit.calls) == 3
