"""Core datatypes of the serving cluster and its planner (the port's copy).

The port's copy of the JAX package's ``core/types.py``: workload types,
replica configurations with their serving role, deployments, and the
hardware and cluster specs the planner prices them with.  Terminology
follows the paper:
  - A *workload type* j clusters requests by (input_len, output_len); its arrival
    rate lambda_j is the number of requests arriving in one time span (1 minute).
  - A *replica* k is one model instance deployed on `chips` devices with a
    (tp, pp) parallelism strategy.  dp degree of the cluster = number of replicas.
  - A *deployment* is the list of replicas (resource allocation + strategies).
  - A *serving strategy* = deployment + workload assignment x[k][j].

On one card a replica's chips are the runtime's own accounting: they scale
its share of the one shared KV pool, its slots and its context ceiling
(``serving.cluster``).  The planner prices them with ``HardwareSpec``'s
roofline constants, by default ``H100_SPEC``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class WorkloadType:
    """One k-means cluster of requests.

    Attributes:
      in_len / out_len: centroid sequence lengths (tokens).
      rate: arrival rate for the current time span (requests / span).
      cached_frac: observed fraction of this type's prompt tokens served
        from the prefix cache (0 = every prompt prefills from token 0).
        Fed back from the runtime (``Orchestrator.observe_prefix_hits``);
        the cost model discounts per-type prefill compute by it, so
        shared-prefix-heavy types steer toward warm pools.
    """

    in_len: int
    out_len: int
    rate: float = 0.0
    cached_frac: float = 0.0

    @property
    def total_len(self) -> int:
        return self.in_len + self.out_len

    def with_rate(self, rate: float) -> "WorkloadType":
        return dataclasses.replace(self, rate=rate)

    def with_cached_frac(self, cached_frac: float) -> "WorkloadType":
        return dataclasses.replace(
            self, cached_frac=min(max(float(cached_frac), 0.0), 1.0))


# Serving roles for disaggregated prefill/decode deployments: a "mixed"
# replica runs both phases (the default, and the only pre-disaggregation
# behavior); a "prefill" replica admits new requests and hands the finished
# context to a "decode" replica at first-token readiness; a "decode"
# replica never admits new requests — it only adopts handed-off contexts
# and runs the fused decode loop.
REPLICA_ROLES = ("mixed", "prefill", "decode")


@dataclasses.dataclass(frozen=True)
class ReplicaConfig:
    """Parallelism strategy (and serving role) for one model replica.

    tp * pp == chips.  `tp` may be non-power-of-two (the paper uses TP=3).
    ``role`` defaults to "mixed"; see ``REPLICA_ROLES`` and
    ``docs/architecture.md`` for the disaggregated prefill/decode split.
    """

    tp: int
    pp: int = 1
    role: str = "mixed"

    def __post_init__(self):
        if self.role not in REPLICA_ROLES:
            raise ValueError(f"unknown replica role {self.role!r} "
                             f"(expected one of {REPLICA_ROLES})")

    @property
    def chips(self) -> int:
        return self.tp * self.pp

    def with_role(self, role: str) -> "ReplicaConfig":
        return dataclasses.replace(self, role=role)

    def __str__(self) -> str:  # matches the paper's "(TP=3, PP=2)" notation
        tag = "" if self.role == "mixed" else f", {self.role}"
        if self.pp == 1:
            return f"(TP={self.tp}{tag})"
        return f"(TP={self.tp}, PP={self.pp}{tag})"


@dataclasses.dataclass(frozen=True)
class Deployment:
    """A heterogeneous model deployment: one ReplicaConfig per replica."""

    replicas: tuple[ReplicaConfig, ...]

    @property
    def dp(self) -> int:
        return len(self.replicas)

    @property
    def total_chips(self) -> int:
        return sum(r.chips for r in self.replicas)

    def __str__(self) -> str:
        return f"DP={self.dp} [" + ", ".join(str(r) for r in self.replicas) + "]"

    def canonical(self) -> "Deployment":
        """Order-independent form (replicas sorted) for dedup during search."""
        key = lambda r: (-r.chips, -r.tp, -r.pp, r.role)
        return Deployment(tuple(sorted(self.replicas, key=key)))


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    """Roofline constants for one accelerator generation.

    The field names are the JAX package's, so a spec means the same thing
    in both; the port knows one spec, ``H100_SPEC``.  The two efficiencies
    are the achievable fractions of peak matmul rate and of memory rate in
    serving.
    """

    name: str
    peak_flops: float                   # bf16 FLOP/s per chip
    hbm_bw: float                       # bytes/s per chip
    hbm_bytes: float                    # device memory per chip
    ici_bw: float                       # bytes/s per chip-to-chip link
    dcn_bw: float                       # bytes/s per host (between pods)
    chips_per_pod: int
    chips_per_host: int
    host_load_bw: float                 # host->device reload path
    mxu_flops_efficiency: float = 0.6   # achievable fraction of peak
    hbm_efficiency: float = 0.8

    def pod_of(self, chip: int) -> int:
        return chip // self.chips_per_pod

    def host_of(self, chip: int) -> int:
        return chip // self.chips_per_host


H100_SPEC = HardwareSpec(
    name="h100",
    peak_flops=989e12,
    hbm_bw=3.35e12,
    hbm_bytes=80e9,
    ici_bw=400e9,        # NVLink
    dcn_bw=200e9,        # InfiniBand
    chips_per_pod=8,     # one DGX box
    chips_per_host=8,
    host_load_bw=4e9,
)


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    """A serving cluster: `chips` devices with a hardware spec."""

    chips: int
    hw: HardwareSpec = H100_SPEC

    @property
    def pods(self) -> int:
        return max(1, math.ceil(self.chips / self.hw.chips_per_pod))


def valid_strategies(
    chips: int,
    max_tp: int | None = None,
    max_pp: int = 8,
) -> list[ReplicaConfig]:
    """All (tp, pp) factorizations of `chips`, matching the paper's search space.

    TP is capped at the fast-interconnect domain (the paper capped TP at
    8 = one NVLink node).
    """
    out = []
    for tp in range(1, chips + 1):
        if chips % tp:
            continue
        pp = chips // tp
        if max_tp is not None and tp > max_tp:
            continue
        if pp > max_pp:
            continue
        out.append(ReplicaConfig(tp=tp, pp=pp))
    return out


def assignment_as_fractions(
    x: Sequence[Sequence[float]], rates: Sequence[float]
) -> list[list[float]]:
    """x[k][j] request counts -> f[k][j] fraction of type j routed to replica k."""
    frac = []
    for row in x:
        frac.append([row[j] / rates[j] if rates[j] > 0 else 0.0 for j in range(len(row))])
    return frac
