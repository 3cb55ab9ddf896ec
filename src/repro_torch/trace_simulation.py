"""Paper-scale trace experiment: OServe vs every baseline on a calibrated
synthetic Azure-like trace (the Fig. 9-11 reproduction, one command).

The twin of ``examples/trace_simulation.py``: the simulator over the cost
model at H100 rates, on the host (the port prices no other hardware).

    PYTHONPATH=src python -m repro_torch.trace_simulation --trace 2 --spans 30
"""
import argparse

from repro_torch.benchmarks.common import Bench
from repro_torch.serving.baselines import (DynamoPolicy, LlumnixPolicy,
                                           OServePolicy, RoundRobinPolicy,
                                           VLLMReloadPolicy, VLLMStaticPolicy)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="opt-30b")
    ap.add_argument("--chips", type=int, default=16)
    ap.add_argument("--spans", type=int, default=30)
    ap.add_argument("--trace", type=int, default=2)
    ap.add_argument("--hw", choices=["h100"], default="h100")
    args = ap.parse_args(argv)

    print(f"calibrating {args.model} on {args.chips} x {args.hw} ...")
    bench = Bench(args.model, args.chips, args.spans, args.trace, hw=args.hw)
    print(f"trace: {len(bench.requests)} requests over {args.spans} spans "
          f"(~{bench.rate:.0f}/span)")
    cm, cl, arch, avg = (bench.cm, bench.cluster, bench.archetypes,
                         bench.avg_rates)
    policies = {
        "oserve": OServePolicy(cm, cl, arch),
        "oserve(naive-reload)": OServePolicy(cm, cl, arch, naive_reload=True),
        "vllm-static": VLLMStaticPolicy(cm, cl, arch, avg),
        "vllm-reload": VLLMReloadPolicy(cm, cl, arch),
        "llumnix": LlumnixPolicy(cm, cl, arch, avg),
        "round-robin": RoundRobinPolicy(cm, cl, arch, avg),
        "dynamo": DynamoPolicy(cm, cl, arch, avg),
    }
    print(f"{'policy':22s} {'p99':>8s} {'avg':>8s} {'thr':>7s} "
          f"{'drops':>6s} {'switches':>8s}")
    for name, pol in policies.items():
        res, m = bench.run(pol)
        print(f"{name:22s} {m.get('p99', float('nan')):7.1f}s "
              f"{m.get('avg_latency', float('nan')):7.1f}s "
              f"{m['throughput_rps']:6.2f} {m['dropped']:6d} "
              f"{res.switch_spans:8d}")


if __name__ == "__main__":
    main()
