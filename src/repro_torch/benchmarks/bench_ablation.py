"""Paper Fig. 14 ablation: vLLM(reload) -> +heterogeneous deployment ->
+optimal (flow) workload assignment.

The twin of ``benchmarks/bench_ablation.py``.  Reported at the scheduler
level (the paper's Appendix-D completion-time story): for fixed demand
mixes, the max-utilization (makespan proxy) and served throughput of
  (a) best homogeneous deployment + capacity-proportional routing,
  (b) heterogeneous deployment + proportional routing,
  (c) heterogeneous deployment + max-flow assignment (full OServe),
plus the Appendix-D worked example as an exact check.
"""
from __future__ import annotations

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core.assignment import assign_workloads
from repro_torch.core.costmodel import CostModel
from repro_torch.core.deployment import flow_guided_search
from repro_torch.core.flownet import WorkloadFlowNetwork
from repro_torch.core.types import H100_SPEC, WorkloadType
from repro_torch.serving.baselines import _balanced_fractions, _best_uniform


def appendix_d() -> list[str]:
    """The paper's worked example: 20s -> 16.67s -> 13.67s completion."""
    rows = []
    lam = [100.0, 50.0]
    # case 2: split type 2 across two small replicas
    t2 = max(100 / 10.0, (50 / 2) / 3.0)
    # case 3: solved by the flow network (balance fractions)
    horizon = 13.67
    net = WorkloadFlowNetwork(
        lam, [[10 * horizon, 5 * horizon],
              [5 * horizon, 3 * horizon],
              [5 * horizon, 3 * horizon]])
    sol = net.balance(net.solve())
    served = sol.throughput
    rows.append(f"ablation/appendix-d,0,case1=20.0s;case2={t2:.2f}s;"
                f"case3_served={served:.1f}/150@13.67s;"
                f"util={max(sol.utilization):.3f}")
    return rows


def main(fast: bool = True) -> list[str]:
    rows = appendix_d()
    cfg = get_config("opt-66b")
    cm = CostModel(cfg.profile(), hw=H100_SPEC)
    archetypes = [WorkloadType(1275, 287), WorkloadType(139, 133),
                  WorkloadType(1181, 1824), WorkloadType(282, 1121)]
    mixes = {"P1-short": [0.20, 0.60, 0.05, 0.15],
             "P6-long": [0.10, 0.15, 0.45, 0.30]}
    for name, mix in mixes.items():
        # saturating demand exposes capacity differences
        ws = [a.with_rate(4000.0 * m) for a, m in zip(archetypes, mix)]
        dep_u, _ = _best_uniform(cm, 16, ws)
        res_a = assign_workloads(cm, dep_u, ws, balance=False)
        fr = np.array(_balanced_fractions(dep_u, cm, ws))
        rates = np.array([w.rate for w in ws])
        x_prop = fr * rates[None, :]
        util_prop = max(
            sum(x_prop[k][j] / res_a.n_cap[k][j]
                for j in range(len(ws)) if res_a.n_cap[k][j] > 0)
            for k in range(dep_u.dp))
        het = flow_guided_search(cm, 16, ws, max_tp=8, max_pp=4, seed=0)
        res_c = het.assignment
        rows.append(
            f"ablation/{name}/a_homo+prop,0,"
            f"thr={min(x_prop.sum(), res_a.throughput):.0f};util={util_prop:.3f};dep={dep_u}")
        res_b = assign_workloads(cm, het.deployment, ws)
        rows.append(
            f"ablation/{name}/b_hetero+prop,0,"
            f"thr={res_b.throughput:.0f};util={res_b.latency_proxy():.3f};"
            f"dep={het.deployment}")
        rows.append(
            f"ablation/{name}/c_hetero+flow,0,"
            f"thr={res_c.throughput:.0f};util={res_c.latency_proxy():.3f}")
    return rows


if __name__ == "__main__":
    for r in main():
        print(r)
