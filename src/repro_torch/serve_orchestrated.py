"""OServe end-to-end on the port: predictor -> scheduler -> switch planner -> cluster.

The twin of the JAX package's ``examples/serve_orchestrated.py``.  The
default mode drives the control loop over a fluctuating trace at paper
scale and prints per-span decisions: predicted rates, chosen heterogeneous
deployment, workload assignment, and switch cost (ad hoc vs naive reload).
The LSTM forecaster trains and predicts on ``--device`` (the card unless
``cpu`` is asked for); the planner is host code.

    PYTHONPATH=src python -m repro_torch.serve_orchestrated [--spans 12]

``--real`` executes the same orchestrator's plans on the port's engines via
``ClusterRuntime`` (smoke-scale model, fp32, on ``--device``):
heterogeneous replicas partition one KV pool, typed requests route through
the plan's fractions, deployment switches drain/migrate live requests, and
each span reports predicted vs achieved per-replica traffic shares.

    PYTHONPATH=src python -m repro_torch.serve_orchestrated --real --spans 2

``--trace out.json`` (with ``--real``) additionally records the full
request-lifecycle telemetry and writes a Chrome-trace-event JSON loadable
in Perfetto / ``chrome://tracing``; the export is validated in-process and
a latency-histogram summary plus the planner's prediction calibration
error are printed.

``--shard`` (with ``--real``) executes each replica's (tp, pp) for real:
its chips are carved out of ``--chips`` virtual chips on ``--device`` and
its params and KV pool are sharded over them; switches move in-flight
pages by ``reshard_blocks``.  On one card this runs the sharded path, not
tensor parallelism's speed.

    PYTHONPATH=src python -m repro_torch.serve_orchestrated --real --shard --device cpu

The default model is the JAX example's, opt-30b: its full config is the
planning profile and, with ``--real``, its smoke config runs the engines.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core.costmodel import CostModel
from repro_torch.core.orchestrator import Orchestrator
from repro_torch.core.predictor import (LSTMWorkloadPredictor,
                                        WorkloadClusterer, count_series)
from repro_torch.core.types import H100_SPEC, ClusterSpec, WorkloadType
from repro_torch.serving.request import span_of, synthesize_trace


def forecast(spans: int, device="cuda") -> dict:
    """The analytic loop's workload side: a ``synthesize_trace`` of
    ``spans`` spans typed by k-means (k = 4), and a small LSTM (window
    spans // 4, hidden 8) fitted for 40 epochs on the first half of the
    series and predicting each later span on ``device``.  Returns the
    archetypes, the per-span counts, the window, the fitted predictor and
    the predicted rates of every span (the observed counts before the
    window fills)."""
    reqs = synthesize_trace(spans, 800, trace_id=2, seed=0)
    il = np.array([r.in_len for r in reqs])
    ol = np.array([r.out_len for r in reqs])
    clusterer, labels = WorkloadClusterer.fit(il, ol, k=4, seed=0)
    archetypes = [WorkloadType(int(c[0]), int(c[1]))
                  for c in clusterer.raw_centroids]
    counts = count_series(labels, np.array([span_of(r) for r in reqs]),
                          4, spans)
    # small LSTM warm-started on the first spans (window shrunk to fit demo)
    window = max(2, spans // 4)
    lstm = LSTMWorkloadPredictor(4, window=window, hidden=8, seed=0,
                                 device=device)
    lstm.fit(counts[: max(window + 2, spans // 2)] + 1.0, epochs=40)
    preds = [lstm.predict(counts[:s + 1]) if s >= window else counts[s]
             for s in range(spans)]
    return dict(archetypes=archetypes, counts=counts, window=window,
                lstm=lstm, preds=preds)


def run_analytic(args, out=print) -> dict:
    """Plan every span of ``forecast``'s predictions, then a loss of 4
    chips; prints the JAX example's lines and returns the forecast with
    the plans (``plans``, ``failure``)."""
    cfg = get_config(args.model)
    cm = CostModel(cfg.profile(), hw=H100_SPEC)
    cluster = ClusterSpec(args.chips, hw=H100_SPEC)
    orch = Orchestrator(cm, cluster)
    fc = forecast(args.spans, args.device)
    archetypes, counts = fc["archetypes"], fc["counts"]

    out(f"{args.model} on {args.chips} x H100 | "
        f"types: {[(w.in_len, w.out_len) for w in archetypes]}")
    plans = []
    for s, pred in enumerate(fc["preds"]):
        ws = [a.with_rate(float(r)) for a, r in zip(archetypes, pred)]
        plan = orch.plan_span(ws)
        plans.append(plan)
        frac = np.array(plan.fractions)
        dominant = [int(np.argmax(frac[:, j])) if frac[:, j].sum() > 0 else -1
                    for j in range(4)]
        switch = (f"switch {plan.switch_seconds:.2f}s "
                  f"(reload would be {plan.reload_seconds:.0f}s)"
                  if plan.changed_replicas else "no switch")
        out(f"span {s:2d} | pred={np.round(pred).astype(int)} | "
            f"{plan.deployment} | type->replica {dominant} | {switch} | "
            f"search {plan.search_time:.2f}s")

    # fault tolerance: lose 4 chips, re-plan on survivors
    ws = [a.with_rate(float(r)) for a, r in zip(archetypes, counts[-1])]
    plan = orch.on_cluster_change(args.chips - 4, ws)
    out(f"FAILURE of 4 chips -> re-planned {plan.deployment} "
        f"on {args.chips - 4} chips, switch {plan.switch_seconds:.2f}s")
    return dict(fc, plans=plans, failure=plan)


def run_real(args) -> None:
    from repro_torch.serving.validation import run_real_spans

    telemetry = None
    if args.trace:
        from repro_torch.serving.telemetry import Telemetry
        telemetry = Telemetry()
    outcomes, runtime = run_real_spans(
        model=args.model, chips=args.chips, n_spans=args.spans,
        requests_per_span=args.requests_per_span, seed=args.seed,
        shard=args.shard, telemetry=telemetry, rebalance=args.rebalance,
        disagg=args.disagg, device=args.device)
    mode = "sharded engines" if args.shard else "real engines"
    print(f"{runtime.cfg.name} ({mode}, {args.device}) planning as "
          f"{args.model} on {args.chips} chips")
    for o in outcomes:
        switch, report = o.switch, o.report
        if o.span == 0:
            sw = "initial build"
        elif switch.changed:
            sw = (f"switch: rebuilt {switch.changed}, "
                  f"drained {switch.drained}, migrated {switch.migrated} "
                  f"(handoff {switch.handoff}, copied {switch.copied}, "
                  f"re-prefilled {switch.reprefilled}), "
                  f"requeued {switch.requeued}")
        else:
            sw = "no switch"
        print(f"span {o.span} | {o.plan.deployment} | {sw}")
        print(f"  predicted replica share {np.round(o.predicted_share, 2)} | "
              f"achieved (tokens) {np.round(o.achieved_share, 2)} | "
              f"completed {report.completed}/{o.n_requests} | "
              f"health {np.round(report.achieved_fraction, 2)} | "
              f"observed-rate EWMA {np.round(o.observed_rates, 1)}")
        if args.disagg and report.handoffs:
            ho = report.handoff
            print(f"  disagg: {report.handoffs} prefill->decode handoffs "
                  f"(page-handoff {ho.handoff}, copied {ho.copied}, "
                  f"recompute {ho.recompute_tokens} tokens) | "
                  f"role util {report.role_util}")
        if args.rebalance:
            rb = report.rebalance
            print(f"  rebalance: moved {report.rebalanced} "
                  f"(handoff {rb.handoff}, copied {rb.copied}, "
                  f"re-prefilled {rb.reprefilled}, requeued {rb.requeued}) | "
                  f"preempted {report.preempted}")
        if report.prefix_hit_rate is not None:
            rate = np.round(np.nan_to_num(report.prefix_hit_rate), 2)
            print(f"  prefix cache: hits {report.prefix_hits} / "
                  f"misses {report.prefix_misses} | "
                  f"per-type hit rate {rate} | "
                  f"evicted {report.prefix_evicted_bytes}B / "
                  f"restored {report.prefix_restored_bytes}B")
    stats = runtime.load_stats()
    eff = [s.get("free_blocks_effective") for s in stats]
    if any(e is not None for e in eff):
        print(f"  hit-rate-adjusted free capacity (blocks, incl. cold "
              f"cached pages): {eff}")
    total = args.spans * args.requests_per_span
    done = sum(1 for r in runtime.results.values() if r.done)
    # span 0 is the initial build, not a switch
    print(f"total completed {done}/{total}; "
          f"switches executed: "
          f"{sum(1 for r in runtime.switch_reports[1:] if r.changed)}")
    assert done == total, "some requests never completed"
    if telemetry is not None:
        from repro_torch.serving.telemetry import (export_chrome_trace,
                                                   validate_chrome_trace)
        obj = export_chrome_trace(telemetry, path=args.trace)
        counts = validate_chrome_trace(obj)
        print(f"\ntrace written to {args.trace}: {counts['events']} events, "
              f"{counts['tracks']} tracks, {counts['slices']} slices, "
              f"{counts['flows']} migration flows "
              f"(load in Perfetto / chrome://tracing)")
        print(telemetry.metrics.summary_table())
        calib = telemetry.audit.calibration_error()
        if calib is not None:
            print(f"planner calibration error (mean L1, predicted vs "
                  f"realized replica token share): {calib:.3f} over "
                  f"{sum(1 for r in telemetry.audit.records if r.joined)} "
                  f"joined decisions")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--spans", type=int, default=12)
    ap.add_argument("--chips", type=int, default=16)
    ap.add_argument("--model", default="opt-30b")
    ap.add_argument("--device", default="cuda",
                    help="where the LSTM and, with --real, the engines run "
                         "(cuda or cpu)")
    ap.add_argument("--real", action="store_true",
                    help="execute plans on real engines (smoke-scale model)")
    ap.add_argument("--shard", action="store_true",
                    help="with --real: execute each replica's (tp, pp) on a "
                         "sub-mesh of its own --chips virtual chips on "
                         "--device")
    ap.add_argument("--rebalance", action="store_true",
                    help="with --real: enable the live rebalancer (watchdog "
                         "straggler drains, hot-spot relief, priority "
                         "preemption) and print per-span move counters")
    ap.add_argument("--disagg", action="store_true",
                    help="with --real: let the planner split replicas into "
                         "prefill/decode roles; first-token-ready contexts "
                         "hand off to decode replicas (zero recompute)")
    ap.add_argument("--requests-per-span", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", metavar="OUT.json", default=None,
                    help="with --real: record lifecycle telemetry and write "
                         "a Chrome-trace-event JSON (Perfetto-loadable)")
    args = ap.parse_args(argv)
    if args.real:
        run_real(args)
    else:
        run_analytic(args)


if __name__ == "__main__":
    main()
