"""Request routing policies behind one interface.

The port's own copy of the JAX package's ``serving/router.py`` (numpy only).

``FlowRouter`` realizes the lower-level assignment x[k][j]: per workload type
it routes by largest-deficit (deterministic low-discrepancy realization of the
fractional solution).  Baselines: round-robin (DeepSpeed-MII), least-loaded
(Llumnix-style), KV/load-aware (Dynamo-style).

Every policy implements the same entry points, so ``ClusterRuntime`` and the
baselines swap routers without isinstance checks:

  * ``route(type_id, up)`` — pick a replica for one typed request;``up`` is
    an optional boolean mask of replicas currently admitting.
  * ``update_loads(loads)`` — inject current per-replica load (a no-op for
    policies that don't use it; ``LeastLoadedRouter`` stores it).
  * ``reconfigure(fractions)`` — adopt a new span plan's [k][j] assignment
    (policies that ignore fractions just resize to the new replica count).
"""
from __future__ import annotations

import numpy as np


class Router:
    """Shared interface; subclasses override ``route`` (and what they need)."""

    def route(self, type_id: int, up: np.ndarray | None = None) -> int:
        raise NotImplementedError

    def update_loads(self, loads) -> None:
        """Per-replica load snapshot; ignored unless the policy is load-aware."""

    def reconfigure(self, fractions) -> None:
        """Adopt a new span plan ([k][j] fractions; shape fixes replica count)."""


class FlowRouter(Router):
    def __init__(self, fractions: list[list[float]]):
        """fractions[k][j]: share of type-j traffic for replica k."""
        self.f = np.asarray(fractions, dtype=np.float64)
        self.sent = np.zeros_like(self.f)
        self.seen = np.zeros(self.f.shape[1])

    def update(self, fractions: list[list[float]]) -> None:
        """Adopt a new span's fractions.  Deficit state always resets: the
        assignment is per-span, so traffic routed under the old fractions
        must not be 'corrected' retroactively under the new ones."""
        f = np.asarray(fractions, dtype=np.float64)
        self.f = f
        self.sent = np.zeros_like(f)
        self.seen = np.zeros(f.shape[1])

    reconfigure = update

    def route(self, type_id: int, up: np.ndarray | None = None) -> int:
        """Pick the replica with the largest routing deficit for this type."""
        j = type_id
        self.seen[j] += 1
        deficit = self.f[:, j] * self.seen[j] - self.sent[:, j]
        if up is not None:
            deficit = np.where(up, deficit, -np.inf)
        k = int(np.argmax(deficit))
        self.sent[k, j] += 1
        return k


class RoundRobinRouter(Router):
    def __init__(self, n_replicas: int):
        self.n = n_replicas
        self.i = 0

    def update(self, n_replicas: int) -> None:
        self.n = n_replicas
        self.i = 0

    def reconfigure(self, fractions) -> None:
        self.update(len(fractions))

    def route(self, type_id: int, up=None) -> int:
        for _ in range(self.n):
            k = self.i % self.n
            self.i += 1
            if up is None or up[k]:
                return k
        return 0


class LeastLoadedRouter(Router):
    """Route to the replica with the lowest normalized load (queue + running
    work / capacity weight).  Loads are injected via ``update_loads`` before
    each decision (the cluster runtime does this from ``load_stats``)."""

    def __init__(self, n_replicas: int = 0):
        self.loads = np.zeros(n_replicas, dtype=np.float64)

    def update_loads(self, loads) -> None:
        self.loads = np.asarray(loads, dtype=np.float64)

    def reconfigure(self, fractions) -> None:
        self.loads = np.zeros(len(fractions), dtype=np.float64)

    def route(self, type_id: int, up=None) -> int:
        return self.route_from_loads(self.loads, up)

    def route_from_loads(self, loads: np.ndarray, up=None) -> int:
        loads = np.asarray(loads, dtype=np.float64)
        if up is not None:
            loads = np.where(up, loads, np.inf)
        return int(np.argmin(loads))
