"""Core datatypes of the serving cluster (the port's own copy).

The part of the JAX package's ``core/types.py`` the cluster runtime needs:
workload types, replica configurations with their serving role, and
deployments.  Terminology follows the paper:
  - A *workload type* j clusters requests by (input_len, output_len); its arrival
    rate lambda_j is the number of requests arriving in one time span (1 minute).
  - A *replica* k is one model instance deployed on `chips` devices with a
    (tp, pp) parallelism strategy.  dp degree of the cluster = number of replicas.
  - A *deployment* is the list of replicas (resource allocation + strategies).

On one card a replica's chips are the runtime's own accounting: they scale
its share of the one shared KV pool, its slots and its context ceiling
(``serving.cluster``).  The hardware and cluster specs come with the
planner.
"""
from __future__ import annotations

import dataclasses


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
