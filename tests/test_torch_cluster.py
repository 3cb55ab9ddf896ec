"""The port's ``ClusterRuntime`` against the JAX package's, on the same
weights (yi-9b smoke, fp32, the CPU) and the same seeded requests: a
two-span heterogeneous switch with requests in flight (``test_cluster.py``'s
orchestrated switch in miniature, with a plan written by hand), the same
switch rolled back by a fault mid-commit, a fail / repair round with the
rebalancer and the prefix cache on, quota partition and the small
replica's context ceiling, and ``shard=True`` serving MoE, SSM and
hybrid models.  A recording stand-in
orchestrator passed to both runtimes must receive the same calls.  Each
JAX scenario runs once per module."""
import functools

import numpy as np
import pytest

from torch_cluster_twins import (RecordingOrch, cluster_state, package,
                                 plain, plan, runtime)

# two spans over 6 chips and 4 request types: span 0 favours short tasks on
# four replicas, span 1 moves to three, rebuilding replicas 0-2 and
# dropping replica 3
SPANS = (
    ([(2, 1), (2, 1), (1, 1), (1, 1)],
     [[0.1, 0.4, 0.1, 0.2], [0.1, 0.4, 0.1, 0.2],
      [0.4, 0.1, 0.4, 0.3], [0.4, 0.1, 0.4, 0.3]]),
    ([(3, 1), (1, 1), (2, 1)],
     [[0.5, 0.2, 0.5, 0.5], [0.2, 0.4, 0.2, 0.2], [0.3, 0.4, 0.3, 0.3]]),
)


def _span_requests(rng, vocab, rid0):
    out = []
    for i in range(6):
        t = int(rng.randint(0, 4))
        prompt = rng.randint(0, vocab, 6 + 2 * t).astype(np.int32)
        out.append((rid0 + i, prompt, 8 + t, t))
    return out


@functools.lru_cache(maxsize=None)
def _switch(name, fault):
    """Two spans, a switch between them (drain window 0: everything in
    flight migrates), 4 ticks a span, then to idle.  ``fault`` arms a
    ``switch_migrate`` fault on the second ``apply_plan``."""
    pkg = package(name)
    orch = RecordingOrch(6)
    faults = (pkg.FaultPlan([pkg.FaultSpec("switch_migrate", 2)])
              if fault else None)
    rt = runtime(pkg, orch=orch, blocks_per_chip=16, seqs_per_chip=1,
                 block_size=8, drain_steps=0, faults=faults)
    rng = np.random.RandomState(0)
    spans, switches = [], []
    rid = 0
    for rcs, fractions in SPANS:
        switches.append(plain(rt.apply_plan(plan(pkg, rcs, fractions))))
        for r, prompt, n, t in _span_requests(rng, pkg.cfg.vocab_size, rid):
            rt.submit(r, prompt, n, type_id=t)
        rid += 6
        for _ in range(4):
            rt.step()
        spans.append(plain(rt.finish_span()))
    rt.run_until_idle()
    spans.append(plain(rt.finish_span()))
    return dict(state=cluster_state(rt), spans=spans, switches=switches,
                calls=orch.calls, n=rid)


@functools.lru_cache(maxsize=None)
def _fail_repair(name):
    """Three replicas with the rebalancer and the prefix cache on: replica
    1 is killed mid-span (pages kept), the span closes, replica 1 is
    repaired and serves a second wave."""
    pkg = package(name)
    orch = RecordingOrch(4)
    rt = runtime(pkg, orch=orch, blocks_per_chip=32, seqs_per_chip=2,
                 block_size=8, drain_steps=1, prefix_cache=True,
                 rebalance=True,
                 router=pkg.FlowRouter([[0.5, 0.5], [0.25, 0.25],
                                        [0.25, 0.25]]))
    rt.apply_plan(plan(pkg, [(2, 1), (1, 1), (1, 1)],
                       [[0.5, 0.5], [0.25, 0.25], [0.25, 0.25]]))
    rng = np.random.RandomState(5)
    shared = rng.randint(0, pkg.cfg.vocab_size, 16).astype(np.int32)
    for rid in range(8):
        tail = rng.randint(0, pkg.cfg.vocab_size, 4 + rid).astype(np.int32)
        rt.submit(rid, np.concatenate([shared, tail]), 6 + rid % 3,
                  type_id=rid % 2, priority=int(rid == 7))
    rt.step()
    rt.step()
    recovery = plain(rt.fail_replica(1, reason="test kill"))
    rt.step()
    spans = [plain(rt.finish_span())]
    rt.repair_replica(1)
    for rid in range(8, 12):
        rt.submit(rid, np.concatenate([shared, shared[:rid - 6]]), 5,
                  type_id=rid % 2)
    rt.run_until_idle()
    spans.append(plain(rt.finish_span()))
    return dict(state=cluster_state(rt), spans=spans, recovery=recovery,
                calls=orch.calls)


@pytest.mark.parametrize("fault", [False, True], ids=["switch", "rollback"])
def test_switch_matches_jax(fault):
    want, got = _switch("jax", fault), _switch("torch", fault)
    assert got["switches"] == want["switches"]
    assert got["spans"] == want["spans"]
    assert got["state"] == want["state"]
    # every request finished, and the switch moved requests in flight
    assert sorted(got["state"]["tokens"]) == list(range(got["n"]))
    sw = got["switches"][1]
    assert sw["rolled_back"] == fault
    if fault:
        assert "injected migration failure" in sw["failure"]
        assert got["state"]["rcs"] == [(2, 1, "mixed"), (2, 1, "mixed"),
                                      (1, 1, "mixed"), (1, 1, "mixed")]
    else:
        assert sw["changed"] == [0, 1, 2] and sw["migrated"] >= 1
        assert sw["handoff"] == sw["migrated"]
    free, reserved = got["state"]["free"], got["state"]["reserved"]
    assert sorted(free) == list(range(6 * 16)) and reserved == 0


@pytest.mark.parametrize("fault", [False, True], ids=["switch", "rollback"])
def test_orchestrator_receives_the_same_calls(fault):
    want, got = _switch("jax", fault), _switch("torch", fault)
    assert got["calls"] == want["calls"]
    names = [c[0] for c in got["calls"]]
    assert names.count("observe_health") == 3
    assert ("on_switch_rollback" in names) == fault


def test_fail_repair_matches_jax():
    want, got = _fail_repair("jax"), _fail_repair("torch")
    assert got["recovery"] == want["recovery"]
    assert got["spans"] == want["spans"]
    assert got["state"] == want["state"]
    assert got["calls"] == want["calls"]
    names = [c[0] for c in got["calls"]]
    for call in ("observe_failures", "observe_rejoin", "observe_rebalance",
                 "observe_prefix_hits", "observe_inflight"):
        assert call in names, call
    assert got["state"]["dead"] == ([1], [1], 0)
    assert sorted(got["state"]["tokens"]) == list(range(12))
    assert got["spans"][0]["prefix_hits"] >= 1


def test_quota_partition_and_small_replica_ceiling():
    """A replica's chips scale its quota, slots and context ceiling in the
    one pool alike in both packages; a request no replica can hold is
    refused before any state moves."""
    got = {}
    for name in ("jax", "torch"):
        pkg = package(name)
        rt = runtime(pkg, total_chips=4, blocks_per_chip=8, seqs_per_chip=1,
                     block_size=8)
        rt.apply_plan(plan(pkg, [(2, 1), (1, 1), (1, 1, "decode")],
                           [[0.4, 0.4], [0.3, 0.3], [0.3, 0.3]]))
        engines = [h.engine for h in rt.replicas]
        with pytest.raises(ValueError, match="context ceiling"):
            rt.submit(0, np.zeros(200, np.int32), 4, type_id=1)
        got[name] = dict(
            pool=rt.pool.num_blocks,
            sizing=[rt._sizing(h.rc) for h in rt.replicas],
            quota=[e.cache.quota for e in engines],
            max_seqs=[e.max_seqs for e in engines],
            max_context=[e.max_context for e in engines],
            fits=[[e.fits(n, 4) for n in (60, 61, 124, 125)]
                  for e in engines],
            counts=plain(rt._span_type_counts))
    assert got["torch"] == got["jax"]
    assert got["torch"]["max_context"] == [128, 64, 128]
    assert got["torch"]["counts"] == [0.0, 0.0]


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "granite-moe-3b-a800m",
                                  "mamba2-370m", "hymba-1.5b"])
def test_shard_serves_every_family(arch):
    """``shard=True``, with ``devices=`` and without, builds a (tp 2)
    replica of a MoE, SSM or hybrid model and serves it to completion with
    the unsharded engine's tokens."""
    pkg = package("torch", arch)
    rng = np.random.RandomState(0)
    jobs = [(rng.randint(0, pkg.cfg.vocab_size, 6 + 4 * (i % 2))
             .astype(np.int32), 5 + i) for i in range(3)]
    ref = pkg.engine(num_blocks=64, block_size=8, max_seqs=4)
    for i, (p, n) in enumerate(jobs):
        ref.submit(i, p, n)
    want = {r.rid: r.generated for r in ref.run_to_completion()}
    for kw in (dict(shard=True), dict(shard=True, devices=["cpu"] * 2)):
        rt = runtime(pkg, total_chips=2, blocks_per_chip=16,
                     seqs_per_chip=2, block_size=8, **kw)
        rt.apply_plan(plan(pkg, [(2, 1)], [[1.0]]))
        assert rt.replicas[0].engine._mesh.devices.size == 2
        for i, (p, n) in enumerate(jobs):
            rt.submit(i, p, n)
        rt.run_until_idle()
        assert {i: rt.results[i].generated for i in range(3)} == want, kw
