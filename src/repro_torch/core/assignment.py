"""Lower-level workload assignment (paper S3.2).

Given a concrete model deployment, profile per-replica capacities with the
cost model, build the workload flow network, and solve for the optimal
x[k][j] assignment (requests of type j routed to replica k this span).
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.costmodel import CostModel, profile_capacities
from repro_torch.core.flownet import FlowSolution, WorkloadFlowNetwork
from repro_torch.core.types import Deployment, WorkloadType, assignment_as_fractions


@dataclasses.dataclass
class AssignmentResult:
    deployment: Deployment
    workloads: list[WorkloadType]
    solution: FlowSolution
    n_cap: list[list[float]]
    e_cap: list[list[float]]

    @property
    def throughput(self) -> float:
        return self.solution.throughput

    @property
    def fractions(self) -> list[list[float]]:
        rates = [w.rate for w in self.workloads]
        return assignment_as_fractions(self.solution.x, rates)

    def latency_proxy(self) -> float:
        """Span completion-time proxy: max over replicas of (load / capacity).

        Matches the Appendix-D examples, where quality of a strategy is the
        max over replicas of its busy time.
        """
        return max(self.solution.utilization, default=0.0)


def assign_workloads(
    cm: CostModel,
    deployment: Deployment,
    workloads: list[WorkloadType],
    capacity_scale: list[float] | None = None,
    balance: bool = True,
) -> AssignmentResult:
    """Solve the lower-level problem for one deployment.

    Args:
      capacity_scale: optional per-replica multiplicative degradation factors
        (EWMA-observed health; straggler mitigation shrinks a slow replica's
        capacity so flow routes around it).
      balance: apply the Appendix-D makespan-balancing post-pass (same
        throughput, minimized max utilization).
    """
    replicas = list(deployment.replicas)
    n, e = profile_capacities(cm, replicas, workloads)
    if capacity_scale is not None:
        n = [[v * capacity_scale[k] for v in row] for k, row in enumerate(n)]
        e = [[v * capacity_scale[k] for v in row] for k, row in enumerate(e)]
    # Per-type latency SLO on the routing edges (paper S5.2: each type goes
    # to the replicas that suit it): a replica whose per-request residence is
    # far worse than the best available for that type gets edge capacity 0 —
    # unless it is the only feasible server for the type.
    slo_mult = 3.0
    for j, w in enumerate(workloads):
        resp = []
        for k, rc in enumerate(replicas):
            p = cm.replica_perf(rc, w)
            resp.append(p.prefill_time + w.out_len * p.decode_step_time
                        if p.fits else float("inf"))
        best = min(resp)
        if best == float("inf"):
            continue
        ok = [k for k in range(len(replicas)) if resp[k] <= slo_mult * best]
        for k in range(len(replicas)):
            if k not in ok:
                e[k][j] = 0.0
    rates = [w.rate for w in workloads]
    net = WorkloadFlowNetwork(rates, n, e)
    sol = net.solve()
    if balance and len(replicas) > 1:
        sol = net.balance(sol)
    return AssignmentResult(deployment, list(workloads), sol, n, e)
