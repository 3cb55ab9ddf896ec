"""Paper Fig. 13 + S5.3 switching-cost study.

The twin of ``benchmarks/bench_switching.py``: its ``h100`` rows (the port
copies no TPU spec).  Two parts:
  1. micro: greedy ad hoc switch-plan transfer time vs naive model reload,
     across representative deployment transitions (the paper: ~10s vs >50s);
  2. macro: end-to-end P99 with OServe using ad hoc switching vs naive
     reloading on the fast-fluctuation trace.
Both are the cost model and the simulator on the host.
"""
from __future__ import annotations

from repro_torch.benchmarks.common import Bench
from repro_torch.configs import get_config
from repro_torch.core.costmodel import CostModel
from repro_torch.core.switching import (place_deployment, plan_kv_migration,
                                        plan_switch)
from repro_torch.core.types import (H100_SPEC, ClusterSpec, Deployment,
                                    ReplicaConfig)
from repro_torch.serving.baselines import OServePolicy

TRANSITIONS = [
    ("consolidate", Deployment((ReplicaConfig(2),) * 8),
     Deployment((ReplicaConfig(8), ReplicaConfig(8)))),
    ("split", Deployment((ReplicaConfig(8, 2),)),
     Deployment((ReplicaConfig(4, 2), ReplicaConfig(4, 2)))),
    ("reshape", Deployment((ReplicaConfig(8), ReplicaConfig(4),
                            ReplicaConfig(4))),
     Deployment((ReplicaConfig(4, 2), ReplicaConfig(4, 2)))),
]


def micro(model: str = "opt-66b") -> list[str]:
    rows = []
    for hw_name, hw in [("h100", H100_SPEC)]:
        cfg = get_config(model)
        cm = CostModel(cfg.profile(), hw=hw)
        cluster = ClusterSpec(16, hw=hw)
        reload_s = cm.reload_seconds()
        for name, src, dst in TRANSITIONS:
            placed_src = place_deployment(src, cluster)
            placed_dst = place_deployment(dst, cluster)
            plan = plan_switch(placed_src, placed_dst, cm, hw)
            t = plan.estimate_seconds(hw)
            kv = plan_kv_migration(cm, {i: 4096 for i in range(8)})
            rows.append(
                f"switch/{model}/{hw_name}/{name},{t*1e6:.0f},"
                f"adhoc={t:.2f}s;reload={reload_s:.1f}s;"
                f"speedup={reload_s/max(t,1e-9):.1f}x;"
                f"moved={plan.moved_bytes()/1e9:.1f}GB;"
                f"local={plan.local_bytes/1e9:.1f}GB;"
                f"kv_migrate={kv.estimate_seconds(hw):.2f}s")
    return rows


def macro(model: str = "opt-30b", chips: int = 16) -> list[str]:
    rows = []
    bench = Bench(model=model, chips=chips, n_spans=40, trace_id=2)
    for name, naive in [("adhoc", False), ("naive-reload", True)]:
        pol = OServePolicy(bench.cm, bench.cluster, bench.archetypes,
                           naive_reload=naive)
        res, m = bench.run(pol)
        rows.append(f"switch-e2e/{model}/{name},{m['sim_seconds']*1e6:.0f},"
                    f"p99={m.get('p99', 0):.1f}s;avg={m.get('avg_latency', 0):.1f}s;"
                    f"drop={m['dropped']};switches={res.switch_spans}")
    return rows


def main(fast: bool = True) -> list[str]:
    return micro() + macro()


if __name__ == "__main__":
    for r in main():
        print(r)
