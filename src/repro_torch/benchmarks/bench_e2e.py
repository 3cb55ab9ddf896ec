"""Paper Figures 9-12: end-to-end latency & throughput, OServe vs baselines.

The twin of ``benchmarks/bench_e2e.py``, with its row names and fields.
One row per (model x chips x trace x policy): P99/avg latency, throughput,
drops, switch count.  `--chips 32` reproduces the 32-GPU scaling study
(Fig. 12); per-span P1-P6 slices reproduce Fig. 9.  These rows are the
discrete-event simulator over the cost model at H100 rates: host code,
no device work, and not a measurement of a card.

``real_validation`` closes the loop on the simulator itself: the same
orchestrator plans are executed on the port's engines (``ClusterRuntime``,
smoke-scale model, on ``device``: the card unless ``"cpu"`` is asked for)
and the planner's predicted per-replica traffic shares are compared
against the shares the engines actually served — the ``e2e-real`` rows
report the L1 share error plus live-switch counters (drained / migrated
requests).
"""
from __future__ import annotations

import numpy as np

from repro_torch.benchmarks.common import Bench
from repro_torch.serving.baselines import (DynamoPolicy, LlumnixPolicy,
                                           OServePolicy, RoundRobinPolicy,
                                           VLLMReloadPolicy, VLLMStaticPolicy)


def policies(bench: Bench) -> dict:
    cm, cl, arch, avg = (bench.cm, bench.cluster, bench.archetypes,
                         bench.avg_rates)
    return {
        "oserve": lambda: OServePolicy(cm, cl, arch),
        "vllm-static": lambda: VLLMStaticPolicy(cm, cl, arch, avg),
        "vllm-reload": lambda: VLLMReloadPolicy(cm, cl, arch),
        "llumnix": lambda: LlumnixPolicy(cm, cl, arch, avg),
        "round-robin": lambda: RoundRobinPolicy(cm, cl, arch, avg),
        "dynamo": lambda: DynamoPolicy(cm, cl, arch, avg),
    }


def compare(bench: Bench, model: str, chips: int, trace_id: int,
            spans_detail: bool = False, hw: str = "h100"
            ) -> tuple[list[str], dict]:
    """``run``'s rows on a built ``bench``, and each policy's
    ``(SimResult, metrics)`` by name."""
    rows = []
    base, results = {}, {}
    for name, mk in policies(bench).items():
        res, m = bench.run(mk())
        base[name] = m
        results[name] = (res, m)
        rows.append(
            f"e2e/{model}/{chips}c/{hw}/t{trace_id}/{name},"
            f"{m['sim_seconds']*1e6:.0f},"
            f"p99={m.get('p99', float('inf')):.1f}s"
            f";avg={m.get('avg_latency', float('inf')):.1f}s"
            f";thr={m['throughput_rps']:.2f}rps"
            f";good={m['goodput_rps']:.2f}rps"
            f";slo={m['slo_attainment']:.2f}"
            f";drop={m['dropped']};switch={res.switch_spans}")
        if spans_detail and name in ("oserve", "vllm-static"):
            picks = np.linspace(1, bench.n_spans - 1, 6).astype(int)  # P1-P6
            for pi, s in enumerate(picks):
                sm = res.span_metrics(int(s))
                rows.append(f"e2e/{model}/{chips}c/t{trace_id}/{name}/P{pi+1},"
                            f"0,p99={sm['p99']:.1f}s;n={sm['n']}")
    if "oserve" in base and "vllm-static" in base:
        o, v = base["oserve"], base["vllm-static"]
        gain_p99 = v.get("p99", 1) / max(o.get("p99", 1e-9), 1e-9)
        gain_thr = o["throughput_rps"] / max(v["throughput_rps"], 1e-9)
        gain_good = o["goodput_rps"] / max(v["goodput_rps"], 1e-9)
        rows.append(f"e2e/{model}/{chips}c/t{trace_id}/gain,0,"
                    f"p99_x={gain_p99:.2f};thr_x={gain_thr:.2f}"
                    f";good_x={gain_good:.2f}")
    return rows, results


def run(model: str = "opt-30b", chips: int = 16, trace_id: int = 1,
        n_spans: int = 40, spans_detail: bool = False,
        hw: str = "h100") -> list[str]:
    bench = Bench(model=model, chips=chips, n_spans=n_spans,
                  trace_id=trace_id, hw=hw)
    return compare(bench, model, chips, trace_id, spans_detail, hw)[0]


def real_validation(model: str = "opt-30b", chips: int = 6,
                    n_spans: int = 2, requests_per_span: int = 6,
                    seed: int = 0, device="cuda") -> list[str]:
    """Execute orchestrator plans on real engines; score plan vs reality.

    Runs with the telemetry layer enabled, so beyond the per-span share
    rows it reports the measured request-latency distributions (TTFT /
    TPOT / queue delay p50/p95/p99 from ``Metrics``) and the decision
    audit's prediction calibration error (mean L1 between each
    ``plan_span``'s predicted replica token share and the share the
    engines realized).  The engines run on ``device``.
    """
    from repro_torch.serving.telemetry import Telemetry
    from repro_torch.serving.validation import run_real_spans

    telemetry = Telemetry()
    outcomes, runtime = run_real_spans(
        model=model, chips=chips, n_spans=n_spans,
        requests_per_span=requests_per_span, seed=seed,
        telemetry=telemetry, device=device)
    rows = []
    for o in outcomes:
        rows.append(
            f"e2e-real/{model}/{chips}c/span{o.span},"
            f"{o.seconds * 1e6:.0f},"
            f"dep={o.plan.deployment};share_l1={o.share_l1:.2f}"
            f";drained={o.switch.drained};migrated={o.switch.migrated}"
            f";handoff={o.switch.handoff}"
            f";recompute={o.switch.recompute_tokens}"
            f";completed={o.report.completed}")
    done = sum(1 for r in runtime.results.values() if r.done)
    rows.append(f"e2e-real/{model}/{chips}c/total,0,"
                f"completed={done}/{n_spans * requests_per_span};switches="
                f"{sum(1 for r in runtime.switch_reports[1:] if r.changed)}")
    for name in ("ttft_s", "tpot_s", "queue_delay_s"):
        h = telemetry.metrics.histograms.get(name)
        if h is None:
            continue
        s = h.summary()
        rows.append(f"e2e-real/{model}/{chips}c/{name},0,"
                    f"n={s['count']};p50={s['p50'] * 1e3:.1f}ms"
                    f";p95={s['p95'] * 1e3:.1f}ms"
                    f";p99={s['p99'] * 1e3:.1f}ms")
    calib = telemetry.audit.calibration_error()
    if calib is not None:
        joined = sum(1 for r in telemetry.audit.records if r.joined)
        rows.append(f"e2e-real/{model}/{chips}c/calibration,0,"
                    f"share_l1={calib:.3f};decisions={joined}")
    return rows


def main(fast: bool = True, device="cuda") -> list[str]:
    rows = []
    combos = ([("opt-30b", 16, 1), ("opt-30b", 16, 2)] if fast else
              [("opt-30b", 16, 1), ("opt-30b", 16, 2),
               ("opt-66b", 16, 1), ("llama2-70b", 16, 1),
               ("llama2-70b", 32, 1), ("llama-30b", 8, 2)])
    for model, chips, trace in combos:
        rows.extend(run(model, chips, trace, spans_detail=True))
    rows.extend(real_validation(n_spans=2 if fast else 4, device=device))
    return rows


if __name__ == "__main__":
    for r in main(fast=False):
        print(r)
