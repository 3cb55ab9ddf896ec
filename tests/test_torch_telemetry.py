"""The port's telemetry (``repro_torch.serving.telemetry``, its own copy of
the JAX package's module): the module's own cases from
``tests/test_telemetry.py`` (ring buffer, disabled no-op, histogram
quantiles, trace validation, the decision audit), the frozen
``load_stats`` key set, and the event streams of the port's engine and
cluster against the JAX package's, event by event — kind, time, rid,
replica and fields — on a clock that advances on every read, so the two
must also read it at the same points.  Under chaos (a crash, a switch that
fails mid-migration, both, a stalled replica drained by the rebalancer)
the port's stream must export a valid Chrome trace and end every request
in exactly one terminal event.  yi-9b smoke, fp32, the CPU; each JAX
scenario runs once per module."""
import functools
import json

import numpy as np
import pytest

from repro_torch.core.types import Deployment, ReplicaConfig, WorkloadType
from repro_torch.serving.engine import LOAD_STATS_KEYS
from repro_torch.serving.telemetry import (ORCH_TID, TERMINAL_KINDS,
                                           DecisionAudit, Histogram,
                                           Telemetry, Tracer,
                                           export_chrome_trace,
                                           validate_chrome_trace)
from torch_cluster_twins import events, package, plan, runtime


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 0.125            # deterministic, strictly increasing
        return self.t


def test_tracer_ring_bound_and_disabled_noop():
    tr = Tracer(clock=FakeClock(), capacity=4)
    for i in range(10):
        tr.emit("submit", rid=i)
    assert len(tr.events) == 4
    assert tr.dropped == 6
    assert [e.rid for e in tr.events] == [6, 7, 8, 9]

    off = Telemetry(enabled=False)
    off.emit("submit", rid=0)
    off.metrics.count("x")
    off.metrics.observe("h", 1.0)
    off.audit.record_realized(None)
    assert not off.tracer.events and not off.metrics.counters
    assert not off.metrics.histograms and not off.audit.records


def test_histogram_log_bucket_percentiles():
    h = Histogram()
    vals = [0.001 * (i + 1) for i in range(1000)]
    for v in vals:
        h.record(v)
    assert h.count == 1000
    assert h.min == pytest.approx(0.001) and h.max == pytest.approx(1.0)
    assert h.mean == pytest.approx(np.mean(vals))
    for p in (50, 95, 99):
        exact = float(np.percentile(vals, p))
        assert h.percentile(p) == pytest.approx(exact, rel=0.11)
    assert h.percentile(0) >= h.min and h.percentile(100) <= h.max
    h2 = Histogram()
    h2.record(-1.0)
    assert h2.percentile(50) == 0.0


def test_validator_rejects_malformed_traces():
    ok = {"traceEvents": [
        {"ph": "B", "name": "sw", "pid": 0, "tid": 1, "ts": 0},
        {"ph": "E", "name": "sw", "pid": 0, "tid": 1, "ts": 5}]}
    assert validate_chrome_trace(ok)["be_pairs"] == 1
    with pytest.raises(ValueError, match="unclosed"):
        validate_chrome_trace({"traceEvents": [
            {"ph": "B", "name": "sw", "pid": 0, "tid": 1, "ts": 0}]})
    with pytest.raises(ValueError, match="unpaired"):
        validate_chrome_trace({"traceEvents": [
            {"ph": "s", "name": "m", "pid": 0, "tid": 1, "ts": 0,
             "id": "a"}]})
    with pytest.raises(ValueError, match="dur"):
        validate_chrome_trace({"traceEvents": [
            {"ph": "X", "name": "r", "pid": 0, "tid": 1, "ts": 0,
             "dur": -1}]})


class _Plan:
    def __init__(self, rcs, fractions, throughput=10.0):
        self.deployment = Deployment(tuple(rcs))
        self.fractions = fractions
        self.throughput = throughput


class _Report:
    def __init__(self, tokens, completed=0):
        self.tokens = tokens
        self.completed = completed


def test_audit_fifo_join_and_calibration():
    audit = DecisionAudit()
    plan2 = _Plan([ReplicaConfig(1, 1)] * 2, [[1.0, 0.0], [0.0, 1.0]])
    w = [WorkloadType(10, 10, rate=3.0), WorkloadType(10, 10, rate=1.0)]
    audit.record_plan(plan2, w, hysteresis_margin=0.1, switched=True)
    assert audit.records[0].predicted_share == pytest.approx([0.75, 0.25])
    assert not audit.records[0].joined
    audit.record_realized(_Report([75, 25], completed=4))
    assert audit.calibration_error() == pytest.approx(0.0)
    audit.record_plan(plan2, w)
    audit.record_realized(_Report([25, 75]))
    assert audit.calibration_error() == pytest.approx(0.5)
    audit.record_plan(plan2, w)
    audit.record_realized(_Report([100]))
    assert audit.records[2].share_l1 == 2.0


def test_load_stats_schema_frozen():
    pkg = package("torch")
    eng = pkg.engine(num_blocks=32, block_size=8, max_seqs=2)
    assert set(eng.load_stats()) == set(LOAD_STATS_KEYS)
    rt = runtime(pkg, total_chips=2, blocks_per_chip=16, seqs_per_chip=2,
                 block_size=8, router=pkg.FlowRouter([[1.0]]))
    rt.apply_plan(plan(pkg, [(1, 1)], [[1.0]]))
    (d,) = rt.load_stats()
    assert set(d) == set(LOAD_STATS_KEYS) | {"dead"}


@functools.lru_cache(maxsize=None)
def _engine_stream(name):
    pkg = package(name)
    tm = pkg.Telemetry(clock=FakeClock())
    eng = pkg.engine(num_blocks=64, block_size=8, max_seqs=2, telemetry=tm,
                     decode_horizon=4)
    assert eng.clock is tm.clock
    rng = np.random.RandomState(3)
    for i in range(3):
        eng.submit(i, rng.randint(0, pkg.cfg.vocab_size, 8 + 3 * i)
                   .astype(np.int32), 6, type_id=i % 2)
    eng.run_to_completion()
    return events(tm), {k: h.summary()
                        for k, h in tm.metrics.histograms.items()}


def test_engine_event_stream_matches_jax():
    got, want = _engine_stream("torch"), _engine_stream("jax")
    assert got == want
    kinds = {e[0] for e in got[0]}
    assert {"submit", "admit", "first_token", "dispatch", "sync",
            "retire"} <= kinds
    assert got[1]["ttft_s"]["count"] == 3


# the chaos cases of ``test_trace_complete_under_chaos`` (seed 11) and the
# watchdog drain of ``test_rebalance_trace_flows_valid``
CHAOS = {
    "crash": dict(crashes=1, stalls=0),
    "failed-switch": dict(crashes=0, stalls=0,
                          switch_failure="switch_migrate"),
    "crash+failed-switch": dict(crashes=1, stalls=0,
                                switch_failure="switch_migrate"),
    "watchdog": None,
}


@functools.lru_cache(maxsize=None)
def _cluster_stream(name, case):
    pkg = package(name)
    if CHAOS[case] is None:
        faults = pkg.FaultPlan([pkg.FaultSpec("stall", 2, replica=0,
                                              steps=10_000)])
        extra = dict(rebalance=pkg.RebalanceConfig(max_moves_per_tick=4))
    else:
        faults = pkg.FaultPlan.seeded(11, n_replicas=2, horizon_ticks=6,
                                      **CHAOS[case])
        extra = {}
    tm = pkg.Telemetry(clock=FakeClock())
    rt = runtime(pkg, total_chips=4, blocks_per_chip=32, seqs_per_chip=4,
                 block_size=8, drain_steps=1,
                 router=pkg.FlowRouter([[0.5], [0.5]]), faults=faults,
                 telemetry=tm, **extra)
    rt.apply_plan(plan(pkg, [(1, 1), (1, 1)], [[0.5], [0.5]]))
    rng = np.random.RandomState(7)
    for rid in range(8):
        rt.submit(rid, rng.randint(0, pkg.cfg.vocab_size, 6 + (rid % 3) * 2)
                  .astype(np.int32), 6 + (rid % 4))
    if CHAOS[case] is not None:
        for _ in range(6):
            rt.step()
        rt.apply_plan(plan(pkg, [(2, 1), (1, 1)], [[0.6], [0.4]]))
    rt.run_until_idle()
    rt.finish_span()
    hists = {k: h.summary() for k, h in tm.metrics.histograms.items()}
    return events(tm), hists, dict(tm.metrics.counters), tm


@pytest.mark.parametrize("case", sorted(CHAOS))
def test_cluster_event_stream_matches_jax(case, tmp_path):
    got, want = _cluster_stream("torch", case), _cluster_stream("jax", case)
    assert got[:3] == want[:3]
    evs, tm = got[0], got[3]
    kinds = {e[0] for e in evs}
    # exactly one terminal event per submitted request
    submitted = {e[2] for e in evs if e[0] == "submit"}
    assert submitted == set(range(8))
    terminals: dict[int, int] = {}
    for e in evs:
        if e[0] in TERMINAL_KINDS:
            terminals[e[2]] = terminals.get(e[2], 0) + 1
    assert terminals.keys() == submitted and set(terminals.values()) == {1}
    for e in evs:
        if e[0] in ("migrate", "rebalance"):
            assert 0 <= e[4]["src"] < 2 and 0 <= e[4]["dst"] < 2
            assert e[4]["path"] in ("handoff", "copy", "reprefill",
                                    "requeue")
    n_crash = sum(1 for e in evs if e[0] == "crash")
    assert n_crash == sum(1 for e in evs if e[0] == "recovered")
    if case == "watchdog":
        assert {"degraded", "rebalance"} <= kinds
    else:
        assert "switch_prepare" in kinds
    if "crash" in case:
        assert n_crash >= 1
    # the export round-trips through JSON and validates
    out = tmp_path / "trace.json"
    export_chrome_trace(tm, path=str(out))
    obj = json.loads(out.read_text())
    counts = validate_chrome_trace(obj)
    tids = {e["tid"] for e in obj["traceEvents"] if e["ph"] != "M"}
    assert len(tids - {ORCH_TID}) >= 2
    assert counts["slices"] >= 8
    if "migrate" in kinds or "rebalance" in kinds:
        assert counts["flows"] >= 1
