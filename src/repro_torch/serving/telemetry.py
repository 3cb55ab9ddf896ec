"""Serving telemetry: request-lifecycle tracing, metrics, decision audit.

The port's own copy of the JAX package's ``serving/telemetry.py`` (pure
Python; the same events, fields, histograms and Chrome-trace export), so
that a trace of the port reads like one of the reference and the two can be
compared event by event.  ``docs/telemetry.md`` is the narrative guide to
reading an exported trace; this docstring is the event schema reference.

Three cooperating pieces, bundled in :class:`Telemetry` and threaded
through the serving stack (``engine.py``, ``cluster.py``,
``prefixcache.py``):

* :class:`Tracer` — structured per-request lifecycle events into a
  bounded ring buffer.  Events are emitted only on the host, at
  scheduling boundaries (dispatch, sync, admission), carry timestamps
  from an injectable monotonic clock (deterministic in tests), and the
  whole path is a true no-op when disabled.
* :class:`Metrics` — a registry of counters, gauges, and log-bucketed
  histograms (TTFT / TPOT / queue delay / switch stall / recovery
  stall) cheap enough to stay on in production.
* :class:`DecisionAudit` — one record per planner decision (an
  orchestrator's ``plan_span``, duck-typed):
  its inputs (workload mix, health scales, ``cached_frac`` EWMAs,
  hysteresis margin, KV-stall price) and the predicted per-replica token
  share, later joined with the realized ``SpanReport`` into a
  calibration-error metric.

Event schema (kind -> required data keys; ``rid`` / ``replica`` are -1
when not applicable):

======================  ======================================================
kind                    data
======================  ======================================================
submit                  type_id, prompt_len, max_new
admit                   reserved_bytes, cached_tokens, queue_delay_s
prefix_hit              tokens, pages
prefill_chunk           tokens, pos
first_token             ttft_s
dispatch                n (batch size), h (horizon)
sync                    n, tokens
retire                  tokens                       [terminal]
shed                    reason ("ttft"|"tpot"|"capacity")  [terminal]
finish_log              tokens                       [terminal; cluster-side]
migrate                 src, dst, path, pages
rebalance               src, dst, path, pages        [mid-span move; same
                                                      flow-arrow render as
                                                      migrate]
handoff                 src, dst, path, pages        [prefill→decode hop of
                                                      a disaggregated
                                                      deployment; same
                                                      flow-arrow render]
preempt                 action ("relocate"|"evict"), for_rid
degraded                ticks (zero-progress count)  [replica-level]
evict                   pages, bytes                 [host tier, replica=-1]
restore                 pages, bytes
crash                   step, kind (fault kind)      [replica-level]
recovered               n (requests moved), stall_s  [replica-level]
plan                    span, switched, margin, kv_stall_s
switch_prepare          phase ("begin"|"end"), span
switch_commit           phase ("begin"|"end"), span
switch_rollback         phase ("begin"|"end"), span
======================  ======================================================

Every submitted request's stream ends in exactly one *terminal* event
(retire / shed / finish_log) — even across crashes and repeated
migrations; ``tests/test_telemetry.py`` enforces this under chaos.

:func:`export_chrome_trace` renders the ring buffer as Chrome
trace-event JSON (chrome://tracing / Perfetto): one track (tid) per
replica plus an orchestrator track, request residency as complete
slices, dispatch->sync windows as nested slices, switch phases as
begin/end pairs, and flow arrows following a request's pages across
migrations.  :func:`validate_chrome_trace` is the CI-side schema check
(``python -m repro_torch.serving.telemetry trace.json``).
"""
from __future__ import annotations

import dataclasses
import json
import math
import time
from collections import deque

TERMINAL_KINDS = frozenset({"retire", "shed", "finish_log"})

# Histogram names recorded by the serving stack (all in seconds).
STANDARD_HISTOGRAMS = ("ttft_s", "tpot_s", "queue_delay_s",
                       "switch_stall_s", "recovery_stall_s")

ORCH_TID = 1000   # trace track for orchestrator / switch events


@dataclasses.dataclass
class Event:
    """One telemetry event.  ``ts`` is seconds on the telemetry clock."""
    __slots__ = ("kind", "ts", "rid", "replica", "data")
    kind: str
    ts: float
    rid: int
    replica: int
    data: dict


class Tracer:
    """Bounded ring buffer of lifecycle events.

    ``emit`` returns immediately when disabled — callers may still guard
    with ``if tracer.enabled`` to skip argument construction.
    """

    def __init__(self, clock=None, capacity: int = 65536,
                 enabled: bool = True):
        self.clock = clock if clock is not None else time.monotonic
        self.enabled = bool(enabled)
        self.capacity = int(capacity)
        self.events: deque[Event] = deque(maxlen=self.capacity)
        self.dropped = 0        # events evicted by the ring bound

    def emit(self, kind: str, rid: int = -1, replica: int = -1,
             **data) -> None:
        if not self.enabled:
            return
        if len(self.events) == self.events.maxlen:
            self.dropped += 1
        self.events.append(Event(kind, self.clock(), rid, replica, data))

    def by_request(self) -> dict[int, list[Event]]:
        """Events grouped per request id (rid >= 0), in emission order."""
        out: dict[int, list[Event]] = {}
        for e in self.events:
            if e.rid >= 0:
                out.setdefault(e.rid, []).append(e)
        return out

    def clear(self) -> None:
        self.events.clear()
        self.dropped = 0


class Histogram:
    """Log-bucketed histogram: O(1) record, ~5% quantile resolution.

    Buckets are powers of ``base`` (default 1.1); values <= 0 land in a
    dedicated underflow bucket.  Exact min/max/sum are tracked so mean
    and range are precise even though quantiles are bucketed.
    """

    def __init__(self, base: float = 1.1):
        self._log_base = math.log(base)
        self._base = base
        self.buckets: dict[int, int] = {}
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf

    def record(self, value: float) -> None:
        v = float(value)
        idx = (math.floor(math.log(v) / self._log_base)
               if v > 0.0 else -(10 ** 6))
        self.buckets[idx] = self.buckets.get(idx, 0) + 1
        self.count += 1
        self.total += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def percentile(self, p: float) -> float:
        """p in [0, 100]; returns a bucket-representative value clamped
        to the exact observed [min, max]."""
        if not self.count:
            return 0.0
        target = max(1, math.ceil(self.count * p / 100.0))
        seen = 0
        for idx in sorted(self.buckets):
            seen += self.buckets[idx]
            if seen >= target:
                if idx <= -(10 ** 6):
                    return max(0.0, self.min)
                rep = self._base ** (idx + 0.5)   # geometric bucket center
                return min(max(rep, self.min), self.max)
        return self.max

    def summary(self) -> dict:
        return {"count": self.count, "mean": self.mean,
                "min": self.min if self.count else 0.0,
                "max": self.max if self.count else 0.0,
                "p50": self.percentile(50), "p95": self.percentile(95),
                "p99": self.percentile(99)}


class Metrics:
    """Registry of counters, gauges, and histograms.

    All mutators are no-ops when disabled; readers always work (they
    just see empty state).
    """

    def __init__(self, enabled: bool = True):
        self.enabled = bool(enabled)
        self.counters: dict[str, float] = {}
        self.gauges: dict[str, float] = {}
        self.histograms: dict[str, Histogram] = {}

    def count(self, name: str, inc: float = 1.0) -> None:
        if not self.enabled:
            return
        self.counters[name] = self.counters.get(name, 0.0) + inc

    def gauge(self, name: str, value: float) -> None:
        if not self.enabled:
            return
        self.gauges[name] = float(value)

    def observe(self, name: str, value: float) -> None:
        if not self.enabled:
            return
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = Histogram()
        h.record(value)

    def summary_table(self) -> str:
        """Fixed-width histogram summary (bench_e2e / --trace output)."""
        rows = [f"{'histogram':<18}{'count':>7}{'mean':>12}"
                f"{'p50':>12}{'p95':>12}{'p99':>12}"]
        names = [n for n in STANDARD_HISTOGRAMS if n in self.histograms]
        names += sorted(set(self.histograms) - set(STANDARD_HISTOGRAMS))
        for name in names:
            s = self.histograms[name].summary()
            rows.append(f"{name:<18}{s['count']:>7d}{s['mean']:>12.6f}"
                        f"{s['p50']:>12.6f}{s['p95']:>12.6f}"
                        f"{s['p99']:>12.6f}")
        for name in sorted(self.counters):
            rows.append(f"{name:<18}{self.counters[name]:>19g}")
        return "\n".join(rows)


@dataclasses.dataclass
class DecisionRecord:
    """One ``plan_span`` decision and (once joined) its realized outcome."""
    span: int
    rates: list[float]                # per-type arrival rates planned for
    out_lens: list[int]               # per-type decode lengths
    cached_frac: list[float]          # per-type EWMA the cost model saw
    health: list[float] | None        # per-replica EWMA capacity scales
    hysteresis_margin: float          # gain bar the switch had to clear
    kv_stall_s: float                 # priced KV-migration stall
    switched: bool
    predicted_share: list[float]      # per-replica token share from the plan
    predicted_throughput: float       # cost-model req/s
    realized_share: list[float] | None = None
    realized_tokens: int = 0
    realized_completed: int = 0

    @property
    def joined(self) -> bool:
        return self.realized_share is not None

    @property
    def share_l1(self) -> float:
        """L1 distance predicted vs realized per-replica token share."""
        if not self.joined:
            return math.nan
        if len(self.realized_share) != len(self.predicted_share):
            return 2.0     # replica set changed mid-span (death): max error
        return float(sum(abs(p - a) for p, a in
                         zip(self.predicted_share, self.realized_share)))


class DecisionAudit:
    """Joins orchestrator predictions with realized span outcomes.

    ``record_plan`` is called by ``Orchestrator.plan_span`` (via the
    ``audit`` attribute the runtime sets); ``record_realized`` by
    ``ClusterRuntime.finish_span``.  Joining is FIFO — the first
    un-joined record takes the next report — which holds because spans
    are strictly sequential.
    """

    def __init__(self, enabled: bool = True):
        self.enabled = bool(enabled)
        self.records: list[DecisionRecord] = []

    def record_plan(self, plan, workloads, health=None,
                    hysteresis_margin: float = 0.0,
                    kv_stall_s: float = 0.0,
                    switched: bool = False) -> None:
        if not self.enabled:
            return
        rates = [float(w.rate) for w in workloads]
        outs = [int(w.out_len) for w in workloads]
        # Predicted per-replica *token* share: the plan routes request
        # fractions; weight by each type's rate x decode length (same
        # scoring as serving.validation).
        loads = []
        for frac_row in plan.fractions:
            loads.append(sum(f * r * o
                             for f, r, o in zip(frac_row, rates, outs)))
        tot = max(sum(loads), 1e-9)
        self.records.append(DecisionRecord(
            span=len(self.records),
            rates=rates, out_lens=outs,
            cached_frac=[float(w.cached_frac) for w in workloads],
            health=None if health is None else [float(h) for h in health],
            hysteresis_margin=float(hysteresis_margin),
            kv_stall_s=float(kv_stall_s), switched=bool(switched),
            predicted_share=[ld / tot for ld in loads],
            predicted_throughput=float(plan.throughput)))

    def record_realized(self, report) -> None:
        """Join a ``SpanReport`` with the oldest un-joined decision."""
        if not self.enabled:
            return
        rec = next((r for r in self.records if not r.joined), None)
        if rec is None:
            return
        tokens = [int(t) for t in report.tokens]
        tot = max(sum(tokens), 1)
        rec.realized_share = [t / tot for t in tokens]
        rec.realized_tokens = sum(tokens)
        rec.realized_completed = int(report.completed)

    def calibration_error(self) -> float:
        """Mean L1 share error over joined decisions (NaN if none)."""
        errs = [r.share_l1 for r in self.records
                if r.joined and not math.isnan(r.share_l1)]
        return sum(errs) / len(errs) if errs else math.nan


class Telemetry:
    """The bundle the serving stack passes around.

    One shared clock feeds the tracer, TTFT/TPOT deadlines, and every
    engine in a cluster, so fake-clock tests get deterministic traces.
    ``NULL_TELEMETRY`` is the module-wide disabled instance used as the
    default everywhere — its clock is still real ``time.monotonic`` so
    un-instrumented engines keep their previous timing behaviour.
    """

    def __init__(self, clock=None, enabled: bool = True,
                 capacity: int = 65536):
        self.clock = clock if clock is not None else time.monotonic
        self.enabled = bool(enabled)
        self.tracer = Tracer(clock=self.clock, capacity=capacity,
                             enabled=enabled)
        self.metrics = Metrics(enabled=enabled)
        self.audit = DecisionAudit(enabled=enabled)

    def emit(self, kind: str, rid: int = -1, replica: int = -1,
             **data) -> None:
        self.tracer.emit(kind, rid, replica, **data)


NULL_TELEMETRY = Telemetry(enabled=False)


# ---------------------------------------------------------------------------
# Chrome trace-event export
# ---------------------------------------------------------------------------

def _us(ts: float, t0: float) -> int:
    return int(round((ts - t0) * 1e6))


def export_chrome_trace(telemetry: Telemetry, path: str | None = None
                        ) -> dict:
    """Render the tracer ring buffer as Chrome trace-event JSON.

    Track layout: pid 0; tid k = replica k's timeline; tid ``ORCH_TID``
    = orchestrator (plan + switch phases).  Per track:

    * request residency — one ``X`` (complete) slice per stay of a
      request on a replica, opened at admit / migrate-in and closed at
      retire / shed / migrate-out / crash (dangling stays are closed at
      the trace end, so slices always balance);
    * ``dispatch -> sync`` horizon windows as short ``X`` slices;
    * instants (``i``) for submit / first_token / prefill_chunk /
      prefix_hit / shed / evict / restore / crash;
    * switch phases as ``B``/``E`` pairs on the orchestrator track;
    * migrations as flow arrows (``s`` on the source slice end, ``f`` on
      the destination slice start) so Perfetto draws the request's hop.
    """
    events = sorted(telemetry.tracer.events, key=lambda e: e.ts)
    trace: list[dict] = []
    if not events:
        out = {"traceEvents": [], "displayTimeUnit": "ms"}
        if path:
            with open(path, "w") as f:
                json.dump(out, f)
        return out
    t0 = events[0].ts
    t_end = events[-1].ts
    tids: set[int] = set()

    def ev(ph, name, ts, tid, **kw):
        d = {"ph": ph, "name": name, "ts": _us(ts, t0), "pid": 0,
             "tid": tid, "cat": "serving"}
        d.update(kw)
        trace.append(d)
        tids.add(tid)

    # rid -> (replica, ts) for the currently-open residency slice
    open_res: dict[int, tuple[int, float]] = {}
    # replica -> (ts, data) for the currently-open dispatch window
    open_disp: dict[int, tuple[float, dict]] = {}
    flow_id = 0

    def close_res(rid, ts):
        if rid in open_res:
            rep, ts_in = open_res.pop(rid)
            ev("X", f"req {rid}", ts_in, rep,
               dur=max(_us(ts, t0) - _us(ts_in, t0), 0),
               args={"rid": rid})
            return rep, ts_in
        return None

    for e in events:
        k = e.kind
        if k == "submit":
            ev("i", f"submit {e.rid}", e.ts, max(e.replica, 0), s="t",
               args=dict(e.data, rid=e.rid))
        elif k == "admit":
            open_res[e.rid] = (e.replica, e.ts)
            ev("i", f"admit {e.rid}", e.ts, e.replica, s="t",
               args=dict(e.data, rid=e.rid))
        elif k in ("prefill_chunk", "prefix_hit", "first_token"):
            ev("i", f"{k} {e.rid}", e.ts, e.replica, s="t",
               args=dict(e.data, rid=e.rid))
        elif k == "dispatch":
            open_disp[e.replica] = (e.ts, dict(e.data))
        elif k == "sync":
            if e.replica in open_disp:
                ts_in, d = open_disp.pop(e.replica)
                d.update(e.data)
                ev("X", "horizon", ts_in, e.replica,
                   dur=max(_us(e.ts, t0) - _us(ts_in, t0), 0), args=d)
        elif k in ("retire", "shed", "finish_log"):
            close_res(e.rid, e.ts)
            ev("i", f"{k} {e.rid}", e.ts,
               e.replica if e.replica >= 0 else ORCH_TID, s="t",
               args=dict(e.data, rid=e.rid))
        elif k in ("migrate", "rebalance", "handoff"):
            src = int(e.data.get("src", e.replica))
            dst = int(e.data.get("dst", e.replica))
            closed = close_res(e.rid, e.ts)
            if closed is not None:
                src = closed[0]
            fid = f"mig-{e.rid}-{flow_id}"
            flow_id += 1
            ev("s", f"{k} {e.rid}", e.ts, src, id=fid,
               args=dict(e.data, rid=e.rid))
            ev("f", f"{k} {e.rid}", e.ts, dst, id=fid, bp="e",
               args=dict(e.data, rid=e.rid))
            open_res[e.rid] = (dst, e.ts)
        elif k == "preempt":
            # eviction sends the victim back to the host log: its residency
            # on the source replica ends here (a later rebalance/admit
            # re-opens it); relocation leaves the close to the rebalance
            # flow arrow that follows
            if e.data.get("action") == "evict":
                close_res(e.rid, e.ts)
            ev("i", f"preempt {e.rid}", e.ts, e.replica, s="t",
               args=dict(e.data, rid=e.rid))
        elif k == "crash":
            # the replica died: its open dispatch window and resident
            # requests end here (recovery re-opens them via migrate)
            if e.replica in open_disp:
                ts_in, d = open_disp.pop(e.replica)
                d["crashed"] = True
                ev("X", "horizon", ts_in, e.replica,
                   dur=max(_us(e.ts, t0) - _us(ts_in, t0), 0), args=d)
            for rid, (rep, _ts) in list(open_res.items()):
                if rep == e.replica:
                    close_res(rid, e.ts)
            ev("i", "crash", e.ts, e.replica, s="t", args=dict(e.data))
        elif k in ("evict", "restore", "recovered", "plan"):
            tid = e.replica if e.replica >= 0 else ORCH_TID
            ev("i", k, e.ts, tid, s="t", args=dict(e.data))
        elif k.startswith("switch_"):
            ph = "B" if e.data.get("phase") == "begin" else "E"
            args = {kk: v for kk, v in e.data.items() if kk != "phase"}
            if ph == "B":
                ev("B", k, e.ts, ORCH_TID, args=args)
            else:
                ev("E", k, e.ts, ORCH_TID)
        else:                       # unknown kinds stay visible as instants
            tid = e.replica if e.replica >= 0 else ORCH_TID
            ev("i", k, e.ts, tid, s="t", args=dict(e.data, rid=e.rid))

    # close dangling state so the trace is balanced no matter where the
    # run stopped
    for rep, (ts_in, d) in list(open_disp.items()):
        d["dangling"] = True
        ev("X", "horizon", ts_in, rep,
           dur=max(_us(t_end, t0) - _us(ts_in, t0), 0), args=d)
    for rid in list(open_res):
        close_res(rid, t_end)

    trace.sort(key=lambda d: d["ts"])
    meta = [{"ph": "M", "pid": 0, "tid": tid, "ts": 0,
             "name": "thread_name",
             "args": {"name": ("orchestrator" if tid == ORCH_TID
                               else f"replica {tid}")}}
            for tid in sorted(tids)]
    out = {"traceEvents": meta + trace, "displayTimeUnit": "ms"}
    if path:
        with open(path, "w") as f:
            json.dump(out, f)
    return out


def validate_chrome_trace(obj) -> dict:
    """Schema-check an exported trace; raises ``ValueError`` on problems.

    Checks: JSON shape, required keys per event, non-negative and
    non-decreasing timestamps, non-negative ``X`` durations, balanced
    ``B``/``E`` pairs per track, and every flow-start ``s`` paired with
    a flow-finish ``f`` of the same id.  Returns summary counts
    (events / tracks / slices / flows / be_pairs / instants).
    """
    if not isinstance(obj, dict) or not isinstance(
            obj.get("traceEvents"), list):
        raise ValueError("trace must be a dict with a traceEvents list")
    events = obj["traceEvents"]
    stacks: dict[tuple, list[str]] = {}
    flows_s: dict[str, int] = {}
    flows_f: dict[str, int] = {}
    last_ts: dict[tuple, int] = {}
    counts = {"events": 0, "slices": 0, "flows": 0, "be_pairs": 0,
              "instants": 0}
    tids = set()
    for i, d in enumerate(events):
        if not isinstance(d, dict):
            raise ValueError(f"event {i} is not an object")
        for key in ("ph", "name", "pid", "tid"):
            if key not in d:
                raise ValueError(f"event {i} missing '{key}'")
        ph = d["ph"]
        if ph == "M":
            continue
        counts["events"] += 1
        tids.add((d["pid"], d["tid"]))
        ts = d.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            raise ValueError(f"event {i} has bad ts {ts!r}")
        track = (d["pid"], d["tid"])
        if ph in ("B", "E"):
            # B/E pair up per track; ts ordering is checked per track
            if ts < last_ts.get(track, 0):
                raise ValueError(
                    f"event {i} ts {ts} decreases on track {track}")
            last_ts[track] = ts
            stack = stacks.setdefault(track, [])
            if ph == "B":
                stack.append(d["name"])
            else:
                if not stack:
                    raise ValueError(
                        f"event {i}: E '{d['name']}' with empty stack "
                        f"on track {track}")
                top = stack.pop()
                if top != d["name"]:
                    raise ValueError(
                        f"event {i}: E '{d['name']}' closes '{top}'")
                counts["be_pairs"] += 1
        elif ph == "X":
            if not isinstance(d.get("dur"), (int, float)) or d["dur"] < 0:
                raise ValueError(f"event {i} X has bad dur")
            counts["slices"] += 1
        elif ph == "s":
            flows_s[d.get("id")] = flows_s.get(d.get("id"), 0) + 1
        elif ph == "f":
            flows_f[d.get("id")] = flows_f.get(d.get("id"), 0) + 1
        elif ph == "i":
            counts["instants"] += 1
    for track, stack in stacks.items():
        if stack:
            raise ValueError(f"unclosed B events on track {track}: {stack}")
    if set(flows_s) != set(flows_f):
        raise ValueError(
            f"unpaired flows: starts {sorted(set(flows_s) - set(flows_f))} "
            f"finishes {sorted(set(flows_f) - set(flows_s))}")
    counts["flows"] = len(flows_s)
    counts["tracks"] = len(tids)
    return counts


def _main(argv) -> int:
    if len(argv) != 1:
        print("usage: python -m repro_torch.serving.telemetry <trace.json>")
        return 2
    with open(argv[0]) as f:
        obj = json.load(f)
    try:
        counts = validate_chrome_trace(obj)
    except ValueError as e:
        print(f"INVALID trace: {e}")
        return 1
    print("valid chrome trace: "
          + " ".join(f"{k}={v}" for k, v in sorted(counts.items())))
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(_main(sys.argv[1:]))
