"""The port's cluster with replica roles and the live rebalancer against
the JAX package's: the twins of ``benchmarks/bench_rebalance.py`` and
``benchmarks/bench_disagg.py`` (the scenarios are ``chip_smoke.py``'s) must
give the JAX cluster's streams and counts and the committed
``BENCH_rebalance.json`` / ``BENCH_disagg.json`` numbers (ticks of a
virtual clock, not times), and the role-routing cases of
``tests/test_disagg.py`` must route alike.  yi-9b smoke, fp32, the CPU;
each JAX scenario runs once per module."""
import functools
import json

import numpy as np
import pytest

from torch_cluster_twins import (ROOT, chip_smoke, cluster_state, package,
                                 plain, plan, runtime)

REBALANCE_KEYS = ("n_requests", "total_shed", "completed", "ticks",
                  "ttft_p95_ticks", "tpot_p95_ticks", "rebalanced",
                  "preempted", "handoff", "requeued", "recompute_tokens")
DISAGG_KEYS = ("n_requests", "completed", "shed", "ticks", "ttft_p95_ticks",
               "tpot_p95_ticks", "handoffs", "handoff_path", "handoff_pages",
               "recompute_tokens", "prefill_tokens", "prompt_tokens",
               "role_util")


@functools.lru_cache(maxsize=None)
def _bench(name, bench, mode):
    pkg = package(name)
    cs = chip_smoke()
    if bench == "rebalance":
        return cs.bench_rebalance_twin(pkg, pkg.cfg, pkg.params, mode == "on")
    return cs.bench_disagg_twin(pkg, pkg.cfg, pkg.params, mode == "disagg")


@pytest.mark.parametrize("mode", ["off", "on"])
def test_bench_rebalance_twin(mode):
    committed = {r["mode"]: r for r in json.loads(
        (ROOT / "BENCH_rebalance.json").read_text())["results"]}[mode]
    want, got = _bench("jax", "rebalance", mode), _bench("torch", "rebalance",
                                                        mode)
    assert got == want
    assert {k: got[k] for k in REBALANCE_KEYS} == {
        k: committed[k] for k in REBALANCE_KEYS}


@pytest.mark.parametrize("mode", ["mixed", "disagg"])
def test_bench_disagg_twin(mode):
    committed = {r["mode"]: r for r in json.loads(
        (ROOT / "BENCH_disagg.json").read_text())["results"]}[mode]
    want, got = _bench("jax", "disagg", mode), _bench("torch", "disagg", mode)
    assert got == want
    assert {k: got[k] for k in DISAGG_KEYS} == {
        k: committed[k] for k in DISAGG_KEYS}
    # disaggregation changes no stream
    assert got["tokens"] == _bench("torch", "disagg", "mixed")["tokens"]


def _disagg_runtime(pkg, fractions=((0.5,), (0.5,)), faults=None):
    fr = [list(f) for f in fractions]
    rt = runtime(pkg, total_chips=4, blocks_per_chip=32, seqs_per_chip=2,
                 block_size=8, drain_steps=1, router=pkg.FlowRouter(fr),
                 faults=faults)
    rt.apply_plan(plan(pkg, [(2, 1, "prefill"), (2, 1, "decode")], fr))
    return rt


def _routes(name):
    """The routing gate: new requests never land on the decode replica,
    decode-phase work never on the prefill one, and the gate relaxes when
    no compatible replica is up."""
    pkg = package(name)
    rng = np.random.RandomState(7)
    rt = _disagg_runtime(pkg, fractions=((0.0,), (1.0,)))
    submitted = [rt.submit(rid, rng.randint(0, pkg.cfg.vocab_size, 8)
                           .astype(np.int32), 6) for rid in range(4)]
    rt = _disagg_runtime(pkg, fractions=((1.0,), (0.0,)))
    phases = [rt._route(0, 16, 4, phase="decode"),
              rt._route(0, 16, 4, phase="prefill")]
    relaxed = []
    for dead, phase in ((1, "decode"), (0, "prefill")):
        rt = _disagg_runtime(pkg)
        rt.fail_replica(dead)
        relaxed.append(rt._route(0, 16, 4, phase=phase))
    return submitted, phases, relaxed


def test_role_routing_matches_jax():
    got = _routes("torch")
    assert got == _routes("jax")
    assert got == ([0, 0, 0, 0], [1, 0], [0, 1])


@functools.lru_cache(maxsize=None)
def _prefill_death(name):
    """The prefill replica crashes at tick 2 with work queued on it:
    recovery relaxes the role gate onto the decode survivor, which then
    takes new submissions too."""
    pkg = package(name)
    rng = np.random.RandomState(7)
    jobs = [(rng.randint(0, pkg.cfg.vocab_size, 6 + (i % 3) * 2)
             .astype(np.int32), 6 + (i % 4)) for i in range(8)]
    rt = _disagg_runtime(pkg, faults=pkg.FaultPlan(
        [pkg.FaultSpec("crash", 2, replica=0)]))
    for rid, (p, n) in enumerate(jobs):
        rt.submit(rid, p, n)
    rt.run_until_idle()
    span = plain(rt.finish_span())
    extra = rt.submit(8, np.arange(8, dtype=np.int32), 4)
    rt.run_until_idle()
    return dict(state=cluster_state(rt), span=span, extra=extra)


def test_prefill_replica_death_matches_jax():
    want, got = _prefill_death("jax"), _prefill_death("torch")
    assert got == want
    span = got["span"]
    assert span["dead_replicas"] == [0]
    rec = span["recovery"]
    assert rec["handoff"] + rec["reprefilled"] + rec["requeued"] >= 1
    assert not got["state"]["all_shed_rids"] and got["extra"] == 1
    assert sorted(got["state"]["tokens"]) == list(range(9))
