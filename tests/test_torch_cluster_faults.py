"""The port's cluster under injected faults against the JAX package's: the
chaos cases of ``tests/test_faults.py`` (a crash with pages kept and lost,
transient dispatch errors retried and escalated, an injected OOM, the
watchdog draining a stalled replica, a preemption victim whose source dies
before it resumes, every replica dead), the engine's TTFT/TPOT shedding
and priority admission, and the ``bench_recovery`` count twin.  The same
``FaultPlan`` goes to both runtimes; yi-9b smoke, fp32, the CPU.  The two
packages must agree on the streams, the span report, every runtime field
of ``torch_cluster_twins.cluster_state`` and the faults fired, and every
request that was not shed must equal a fault-free engine's stream.  Each
JAX scenario runs once per module."""
import functools
import json

import numpy as np
import pytest

from torch_cluster_twins import (ROOT, chip_smoke, cluster_state, package,
                                 plain, plan, runtime)

KINDS = ("crash", "stall", "transient", "oom", "hotspot", "slow",
         "switch_build", "switch_migrate")


def _jobs(vocab, n=8, seed=7):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, vocab, 6 + (i % 3) * 2).astype(np.int32),
             6 + (i % 4)) for i in range(n)]


@functools.lru_cache(maxsize=None)
def _reference(n, extra=False):
    """A fault-free engine's streams of ``_jobs`` (and the high-priority
    request of the preemption case)."""
    pkg = package("torch")
    jobs = _jobs(pkg.cfg.vocab_size, n)
    if extra:
        jobs.append((np.arange(8, dtype=np.int32), 6))
    eng = pkg.engine(num_blocks=256, block_size=8, max_seqs=len(jobs))
    for rid, (p, k) in enumerate(jobs):
        eng.submit(rid, p, k)
    return {r.rid: list(r.generated) for r in eng.run_to_completion()}


def _two_replicas(pkg, faults, **kw):
    kw.setdefault("seqs_per_chip", 4)
    rt = runtime(pkg, total_chips=4, blocks_per_chip=32, block_size=8,
                 drain_steps=1, router=pkg.FlowRouter([[0.5], [0.5]]),
                 faults=faults, **kw)
    rt.apply_plan(plan(pkg, [(1, 1), (1, 1)], [[0.5], [0.5]]))
    return rt


# each case: the fault specs (kind, tick, replica, steps, lose_pages), the
# jobs, the runtime's options, and what the test does before running to
# idle ("fail-all": kill both replicas after 2 ticks; "preempt": saturate,
# queue a priority-2 request, and kill the evicted victim's source)
CASES = {
    "crash-keep-pages": dict(faults=[("crash", 5, 0, 1, False)], n=6),
    "crash-lose-pages": dict(faults=[("crash", 5, 0, 1, True)], n=8),
    "transient-retried": dict(faults=[("transient", 3, 0, 2, False)], n=8),
    "transient-escalates": dict(faults=[("transient", 3, 0, 50, False)],
                                n=8, kw=dict(max_retries=3)),
    "oom": dict(faults=[("oom", 2, 0, 2, False)], n=8),
    "watchdog-stall": dict(faults=[("stall", 2, 0, 10_000, False)], n=8,
                           kw=dict(rebalance="moves4")),
    "preempt-evict-source-dies": dict(faults=[], n=10, act="preempt",
                                      kw=dict(rebalance=True)),
    "all-dead": dict(faults=[], n=4, act="fail-all"),
}


@functools.lru_cache(maxsize=None)
def _chaos(name, case):
    pkg = package(name)
    c = CASES[case]
    faults = pkg.FaultPlan([pkg.FaultSpec(k, t, replica=r, steps=s,
                                          lose_pages=lose)
                            for k, t, r, s, lose in c["faults"]])
    kw = dict(c.get("kw", {}))
    if kw.get("rebalance") == "moves4":
        kw["rebalance"] = pkg.RebalanceConfig(max_moves_per_tick=4)
    tm = pkg.Telemetry(clock=chip_smoke().TickClock())
    rt = _two_replicas(pkg, faults, telemetry=tm, **kw)
    for rid, (p, n) in enumerate(_jobs(pkg.cfg.vocab_size, c["n"])):
        rt.submit(rid, p, n)
    out = {}
    if c.get("act") == "fail-all":
        rt.step()
        rt.step()
        out["recoveries"] = [plain(rt.fail_replica(0)),
                             plain(rt.fail_replica(1))]
        out["pending_after"] = rt.pending
        with pytest.raises(ValueError):
            rt.submit(99, np.arange(4, dtype=np.int32), 4)
    elif c.get("act") == "preempt":
        for _ in range(3):
            rt.step()
        rt.submit(10, np.arange(8, dtype=np.int32), 6, priority=2)
        rt.step()
        out["evicted"] = dict(rt._evicted)
        victim, src = next(iter(rt._evicted.items()))
        rt.fail_replica(src)
    rt.run_until_idle()
    span = plain(rt.finish_span())
    fired = {k: faults.fired(k) for k in KINDS}
    return dict(state=cluster_state(rt), span=span, fired=fired,
                terminals=sorted((e.rid, e.kind) for e in tm.tracer.events
                                 if e.kind in ("retire", "shed",
                                               "finish_log")), **out)


@pytest.mark.parametrize("case", sorted(CASES))
def test_chaos_case_matches_jax(case):
    want, got = _chaos("jax", case), _chaos("torch", case)
    assert got == want
    n = CASES[case]["n"] + (1 if case.startswith("preempt") else 0)
    state, span = got["state"], got["span"]
    # every request finished with the fault-free stream, or was shed
    shed = set(state["all_shed_rids"])
    assert shed | set(state["tokens"]) == set(range(n))
    ref = _reference(CASES[case]["n"], case.startswith("preempt"))
    for rid, toks in state["tokens"].items():
        assert toks == ref[rid], rid
    # one terminal event per request
    assert sorted(r for r, _ in got["terminals"]) == list(range(n))
    assert sorted(state["free"]) == list(range(4 * 32))
    assert state["reserved"] == 0
    if case == "crash-keep-pages":
        assert span["dead_replicas"] == [0]
        assert span["recovery"]["handoff"] >= 1
    elif case == "crash-lose-pages":
        assert span["recovery"]["handoff"] == 0
        assert span["recovery"]["reprefilled"] + \
            span["recovery"]["requeued"] >= 1
    elif case == "transient-retried":
        assert span["retries"] == 2 and not span["dead_replicas"]
    elif case == "transient-escalates":
        assert span["retries"] == 4 and span["dead_replicas"] == [0]
    elif case == "oom":
        assert got["fired"]["oom"] == 2 and span["retries"] >= 1
        assert not span["dead_replicas"]
    elif case == "watchdog-stall":
        assert span["rebalanced"] >= 1 and span["dead_replicas"] == [0]
        assert span["rebalance"]["recompute_tokens"] == 0 and not shed
    elif case == "preempt-evict-source-dies":
        assert span["preempted"] >= 1 and not shed
    elif case == "all-dead":
        assert got["pending_after"] == 0
        assert shed | set(state["tokens"]) == set(range(4))


def _engine_slo(name):
    """One engine on an injected clock: a TPOT budget blown mid-flight, a
    TTFT deadline blown in the queue, and priority admission."""
    pkg = package(name)
    now = [0.0]
    eng = pkg.engine(num_blocks=64, block_size=8, max_seqs=2,
                     clock=lambda: now[0])
    prompt = np.arange(8, dtype=np.int32)
    eng.submit(0, prompt, 12, tpot_deadline=0.5)
    eng.submit(1, prompt, 12)
    eng.submit(2, prompt + 1, 4, ttft_deadline=50.0)
    eng.submit(3, prompt + 2, 4, priority=1)
    trace, done = [], []
    for t in (0.0, 0.0, 100.0, 100.0):
        now[0] = t
        done += eng.step()
        trace.append(([r.rid for r in eng.active.values()],
                      [r.rid for r in eng.waiting], list(eng.shed_rids)))
    done += eng.run_to_completion()
    return dict(trace=trace, shed=list(eng.shed_rids),
                done={r.rid: list(r.generated) for r in done},
                stats=plain(eng.load_stats()))


def test_engine_slo_shedding_and_priority_match_jax():
    want, got = _engine_slo("jax"), _engine_slo("torch")
    assert got == want
    # the priority-1 request was admitted ahead of the queue; at t = 100
    # the waiting request's TTFT deadline has passed and the first one's
    # pace blew its TPOT budget: both were shed, the others completed
    assert got["trace"][0][0] == [3, 0]
    assert got["shed"] == [2, 0] and got["stats"]["shed"] == 2
    assert sorted(got["done"]) == [1, 3]


def test_bench_recovery_counts():
    """The twin of ``benchmarks/bench_recovery.py``'s counts: a replica
    dies with its pages kept (survivors adopt 114 pages, nothing
    recomputed) or lost (900 tokens re-prefilled from the request log);
    the counts must equal the committed ``BENCH_recovery.json``'s and the
    streams a fault-free engine's."""
    bench = json.loads((ROOT / "BENCH_recovery.json").read_text())
    pkg = package("torch")
    keys = ("recovered", "handoff", "reprefilled", "pages_handoff",
            "recompute_tokens")
    streams = []
    for committed in bench["results"]:
        got = chip_smoke().bench_recovery_twin(
            pkg, pkg.cfg, pkg.params, committed["mode"], bench["ctx_len"],
            bench["batch"], bench["new_tokens"])
        assert {k: got[k] for k in keys} == {k: committed[k] for k in keys}
        assert got["dropped"] == 0
        streams.append(got["tokens"])
    assert streams[0] == streams[1]
    assert all(len(t) == bench["new_tokens"] for t in streams[0].values())
