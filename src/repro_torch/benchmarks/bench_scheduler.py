"""Paper Fig. 15: scheduling-algorithm efficiency and optimality.

The twin of ``benchmarks/bench_scheduler.py``.  Runtime of the flow-guided
heuristic vs exhaustive search as the cluster grows, and the
throughput/latency gap between them (paper: heuristic 12s vs exhaustive
50s at 16 GPUs, <6% P99 gap).  The searches are host code; their times
are the host's.
"""
from __future__ import annotations

import time

from repro_torch.configs import get_config
from repro_torch.core.costmodel import CostModel
from repro_torch.core.deployment import exhaustive_search, flow_guided_search
from repro_torch.core.types import H100_SPEC, WorkloadType


def main(fast: bool = True) -> list[str]:
    cfg = get_config("opt-66b")
    cm = CostModel(cfg.profile(), hw=H100_SPEC)
    archetypes = [WorkloadType(1275, 287), WorkloadType(139, 133),
                  WorkloadType(1181, 1824), WorkloadType(282, 1121)]
    ws = [a.with_rate(2000.0) for a in archetypes]
    rows = []
    sizes = [8, 16, 24, 32] if not fast else [8, 16]
    for chips in sizes:
        t0 = time.time()
        fg = flow_guided_search(cm, chips, ws, max_tp=8, max_pp=4, seed=0)
        t_fg = time.time() - t0
        t0 = time.time()
        ex = exhaustive_search(cm, chips, ws, max_tp=8, max_pp=4)
        t_ex = time.time() - t0
        gap = 100 * (1 - fg.throughput / max(ex.throughput, 1e-9))
        rows.append(
            f"scheduler/{chips}gpus,{t_fg*1e6:.0f},"
            f"heuristic={t_fg:.2f}s;exhaustive={t_ex:.2f}s;"
            f"thr_gap={gap:.2f}%;evals={fg.evaluations};"
            f"dep={fg.deployment}")
    return rows


if __name__ == "__main__":
    for r in main(fast=False):
        print(r)
