"""The port's discrete-event simulator and serving policies against the
JAX package's, exactly.

``serving/simulator.py`` and ``serving/baselines.py`` are numpy float64
copies over the planner copies, so the same trace under the same policy
gives the same request times to the bit: every request's ``start``,
``first_token``, ``finish`` and ``replica``, the drops, the switch count,
the deployment log, ``metrics()``, ``span_metrics`` of every span and the
policy's switch statistics (all but the wall-clock ``search_seconds``) are
compared with ``==``.  The setup is ``tests/test_serving.py``'s: opt-30b
priced on 16 H100s, a 6-span trace of trace 2, crude typing."""
import copy
import dataclasses

import numpy as np
import pytest
import torch
from torch_cluster_twins import plain

import repro.configs as jconfigs
import repro.core.costmodel as jcost
import repro.core.types as jtypes
import repro.serving.baselines as jbase
import repro.serving.request as jreq
import repro.serving.simulator as jsim
import repro_torch.configs as tconfigs
import repro_torch.core.costmodel as tcost
import repro_torch.core.types as ttypes
import repro_torch.serving.baselines as tbase
import repro_torch.serving.request as treq
import repro_torch.serving.simulator as tsim

N_SPANS = 6
ARCH = [(1275, 287), (139, 133), (1181, 1824), (282, 1121)]
AVG = np.array([30.0, 30.0, 30.0, 30.0])
PACKAGES = {"jax": (jconfigs, jcost, jtypes, jbase, jreq, jsim),
            "torch": (tconfigs, tcost, ttypes, tbase, treq, tsim)}
# the nine policy variants: OServe and its three ablations, then the
# paper's baselines
POLICIES = {
    "oserve": lambda b, cm, cl, a: b.OServePolicy(cm, cl, a),
    "oserve-naive-reload": lambda b, cm, cl, a: b.OServePolicy(
        cm, cl, a, naive_reload=True),
    "oserve-homogeneous": lambda b, cm, cl, a: b.OServePolicy(
        cm, cl, a, heterogeneous=False),
    "oserve-proportional": lambda b, cm, cl, a: b.OServePolicy(
        cm, cl, a, flow_assignment=False),
    "vllm-static": lambda b, cm, cl, a: b.VLLMStaticPolicy(cm, cl, a, AVG),
    "vllm-reload": lambda b, cm, cl, a: b.VLLMReloadPolicy(cm, cl, a),
    "llumnix": lambda b, cm, cl, a: b.LlumnixPolicy(cm, cl, a, AVG),
    "round-robin": lambda b, cm, cl, a: b.RoundRobinPolicy(cm, cl, a, AVG),
    "dynamo": lambda b, cm, cl, a: b.DynamoPolicy(cm, cl, a, AVG),
}


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread, as every port test file pins."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def setup(pkg):
    """``tests/test_serving.py``'s ``sim_setup`` in one package."""
    configs, cost, types, base, req, sim = PACKAGES[pkg]
    cm = cost.CostModel(configs.get_config("opt-30b").profile(),
                        hw=types.H100_SPEC)
    cluster = types.ClusterSpec(16, hw=types.H100_SPEC)
    arch = [types.WorkloadType(i, o) for i, o in ARCH]
    reqs = req.synthesize_trace(N_SPANS, 120, trace_id=2, seed=0)
    for r in reqs:
        # crude typing for the test
        r.type_id = int(r.out_len > 500) * 2 + int(r.in_len > 600)
    return cm, cluster, arch, reqs


@pytest.fixture(scope="module")
def both():
    return {pkg: setup(pkg) for pkg in PACKAGES}


def simulate(pkg, setup_, name):
    cm, cluster, arch, reqs = setup_
    base, sim = PACKAGES[pkg][3], PACKAGES[pkg][5]
    policy = POLICIES[name](base, cm, cluster, arch)
    res = sim.simulate(copy.deepcopy(reqs), policy, cm, arch, N_SPANS)
    return policy, res


def sim_fields(policy, res) -> dict:
    """Everything a run leaves that the two packages must agree on."""
    out = {
        "requests": [(r.rid, r.type_id, r.start, r.first_token, r.finish,
                      r.replica) for r in res.requests],
        "dropped": res.dropped, "switch_spans": res.switch_spans,
        "deployments": res.deployments, "metrics": res.metrics(),
        "spans": [res.span_metrics(s) for s in range(res.spans)]}
    stats = getattr(policy, "stats", None)
    if stats is not None:
        out["stats"] = {k: v for k, v in dataclasses.asdict(stats).items()
                        if k != "search_seconds"}
    return out


@pytest.mark.parametrize("name", list(POLICIES))
def test_simulate_equals_jax(both, name):
    want = sim_fields(*simulate("jax", both["jax"], name))
    got = sim_fields(*simulate("torch", both["torch"], name))
    assert len(got["requests"]) == len(both["torch"][3]) > 500
    assert got == want


def test_trace_and_setup_equal(both):
    (jcm, jcl, jarch, jreqs), (tcm, tcl, tarch, treqs) = (both["jax"],
                                                          both["torch"])
    assert [vars(r) for r in treqs] == [vars(r) for r in jreqs]
    assert plain(tcl) == plain(jcl)
    assert plain(tarch) == plain(jarch)


MIXES = [[0.25, 0.25, 0.25, 0.25], [0.2, 0.6, 0.05, 0.15],
         [0.1, 0.15, 0.45, 0.3]]


# the binary search calls ``flow_guided_search(..., patience=10)`` at ~20
# rates a mix; 16 chips take ~6 s a package, so one mix runs there
@pytest.mark.parametrize("chips,mix", [(8, m) for m in MIXES]
                         + [(16, MIXES[1])])
def test_calibrate_rate_equals_jax(both, chips, mix):
    rates = {pkg: PACKAGES[pkg][3].calibrate_rate(
        both[pkg][0], chips, both[pkg][2], np.asarray(mix), utilization=0.95)
        for pkg in PACKAGES}
    assert rates["torch"] == rates["jax"] > 1.0


@pytest.mark.parametrize("chips", [4, 8, 16])
def test_uniform_deployments_equal_jax(both, chips):
    deps = {pkg: plain(PACKAGES[pkg][3]._uniform_deployments(both[pkg][0],
                                                             chips))
            for pkg in PACKAGES}
    assert deps["torch"] == deps["jax"]
    assert len(deps["torch"]) > 0


@pytest.mark.parametrize("mix", MIXES)
def test_best_uniform_and_balanced_fractions_equal_jax(both, mix):
    got = {}
    for pkg in PACKAGES:
        cm, _, arch, _ = both[pkg]
        base = PACKAGES[pkg][3]
        ws = base._rates_to_workloads(arch, 200.0 * np.asarray(mix))
        dep, frac = base._best_uniform(cm, 16, ws)
        got[pkg] = plain((dep, frac, base._balanced_fractions(dep, cm, ws)))
    assert got["torch"] == got["jax"]


# --------------------------------------------------------------------------
# the twins of tests/test_serving.py's simulator cases, on the port alone
# --------------------------------------------------------------------------


def test_simulator_conservation(both):
    cm, cluster, arch, reqs = both["torch"]
    pol = tbase.VLLMStaticPolicy(cm, cluster, arch, AVG)
    res = tsim.simulate([r for r in copy.deepcopy(reqs)], pol, cm, arch,
                        N_SPANS)
    done = sum(1 for r in res.requests if r.finish >= 0)
    assert done + res.dropped == len(reqs)
    for r in res.requests:
        if r.finish >= 0:
            assert r.finish >= r.start >= r.arrival - 1e-9
            assert r.first_token >= r.start


def test_simulator_oserve_runs(both):
    cm, cluster, arch, reqs = both["torch"]
    pol = tbase.OServePolicy(cm, cluster, arch)
    res = tsim.simulate([r for r in copy.deepcopy(reqs)], pol, cm, arch,
                        N_SPANS)
    m = res.metrics()
    assert m["completed"] > 0
    assert np.isfinite(m.get("p99", np.inf))
