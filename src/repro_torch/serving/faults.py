"""Deterministic chaos injection for the serving cluster.

The port's own copy of the JAX package's ``serving/faults.py`` (pure
Python): the same fault kinds, the same seeded plans, the same exception
classes, so one ``FaultPlan`` drives both packages' clusters alike.

At the paper's "millions of users" scale the spatial-temporal machinery
that reshapes deployments on purpose (span switches) must also absorb
*unplanned* reshaping: replica crashes, stalled devices, transient
dispatch errors, pool-reservation OOMs, and switches that die half-way.
This module provides the reproducible fault source for exercising those
paths — no real faults needed, so the whole recovery stack runs in CI.
The failure model the injected faults drive is described in
``docs/architecture.md``; ``docs/telemetry.md`` explains how crashes,
recoveries and shed requests appear in an exported trace.

A ``FaultPlan`` is a list of ``FaultSpec``s consulted by
``ClusterRuntime`` at well-defined injection sites:

  * ``crash`` — the replica raises ``ReplicaCrash`` at its next dispatch
    attempt once the cluster tick reaches ``spec.tick`` (fires once).
    With ``lose_pages=True`` the recovery path must treat the replica's
    device state as gone and rebuild requests from the cluster's
    host-side token log (re-prefill); otherwise the shared/per-replica
    ``BlockPool`` survives the engine and pages are handed off.
  * ``stall`` — the replica silently skips ``steps`` consecutive ticks
    starting at ``spec.tick`` (a straggler / frozen device; no error is
    raised, progress just halts).  With the cluster's rebalancer enabled
    the step-loop watchdog detects the sustained zero progress, drains
    the replica's requests onto survivors, and escalates to
    ``fail_replica`` — a hang becomes graceful degradation; without it
    only the health feedback loop sees the stall.
  * ``slow`` — slow degradation rather than a freeze: for ``steps``
    ticks the replica only makes progress every ``period``-th tick
    (skipping the rest).  Exercises the watchdog's *low*-progress
    detection and the health EWMA without ever fully halting.
  * ``hotspot`` — traffic-skew injection: for ``steps`` ticks every new
    submission routes to ``spec.replica`` (bypassing the router) while
    the replica is up, deterministically building the queue-depth /
    KV-pressure hot spot the rebalancer's load-relief path drains.
  * ``transient`` — the next ``steps`` dispatch attempts at or after
    ``spec.tick`` raise ``TransientDispatchError``; the cluster retries
    with exponential backoff and only declares the replica dead when the
    consecutive-failure budget (``ClusterRuntime.max_retries``) is
    exhausted.
  * ``oom`` — the next ``steps`` admission attempts raise
    ``InjectedOOM`` (a ``MemoryError``) from inside the engine's admit
    path, before any request state is mutated.
  * ``switch_build`` / ``switch_migrate`` — the ``spec.tick``-th
    ``apply_plan`` call (1-based ordinal) fails while building the new
    engines / between per-destination migration batches, exercising the
    transactional abort / rollback paths.

Plans are stateful for one run (each one-shot spec fires once, budgeted
specs count down); build a fresh plan per run.  ``FaultPlan.seeded``
derives a reproducible mixed plan from an integer seed — the CI chaos
matrix is just a handful of seeds.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

FAULT_KINDS = ("crash", "stall", "slow", "transient", "oom", "hotspot",
               "switch_build", "switch_migrate")


class FaultError(RuntimeError):
    """Base class for injected (and injected-like) serving faults."""


class ReplicaCrash(FaultError):
    """The replica process is gone; its engine must not be used again."""

    def __init__(self, msg: str, lose_pages: bool = False):
        super().__init__(msg)
        self.lose_pages = lose_pages


class TransientDispatchError(FaultError):
    """A dispatch failed but the replica may recover (retry with backoff)."""


class InjectedOOM(FaultError, MemoryError):
    """A pool-reservation failure injected at the admission site."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One fault: what, when, where.

    ``tick`` is the cluster tick the fault arms (for ``switch_*`` kinds it
    is the 1-based ``apply_plan`` ordinal instead).  ``steps`` is the
    stall/slow/hotspot length / the number of transient or OOM firings.
    ``replica`` indexes ``ClusterRuntime.replicas``.  ``period`` applies
    to ``slow`` only: the replica progresses on one of every ``period``
    ticks inside the window.
    """
    kind: str
    tick: int
    replica: int = 0
    steps: int = 1
    lose_pages: bool = False
    period: int = 2

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {FAULT_KINDS}")


class FaultPlan:
    """A deterministic schedule of injected faults for one cluster run."""

    def __init__(self, faults: Sequence[FaultSpec] = ()):
        self.faults = list(faults)
        # remaining firings for budgeted kinds; one-shot kinds use `_fired`
        self._left = {i: f.steps for i, f in enumerate(self.faults)
                      if f.kind in ("transient", "oom")}
        self._fired: set[int] = set()

    @classmethod
    def seeded(cls, seed: int, *, n_replicas: int, horizon_ticks: int = 48,
               crashes: int = 1, stalls: int = 1, transients: int = 0,
               ooms: int = 0, slows: int = 0, hotspots: int = 0,
               lose_pages: bool = False,
               switch_failure: str | None = None,
               switch_ordinal: int = 2) -> "FaultPlan":
        """Derive a reproducible mixed fault plan from an integer seed.

        Fault ticks land in ``[2, horizon_ticks)`` so the cluster is
        mid-decode when they fire; replicas are drawn uniformly.  The same
        (seed, shape) always yields the same plan — the CI chaos matrix
        enumerates seeds, not hand-written schedules.
        """
        rng = np.random.RandomState(seed)

        def draw(kind, n, **kw):
            return [FaultSpec(kind, int(rng.randint(2, horizon_ticks)),
                              int(rng.randint(n_replicas)), **kw)
                    for _ in range(n)]

        specs = draw("crash", crashes, lose_pages=lose_pages)
        specs += draw("stall", stalls, steps=int(rng.randint(2, 7)))
        specs += draw("transient", transients, steps=int(rng.randint(1, 3)))
        specs += draw("oom", ooms, steps=int(rng.randint(1, 3)))
        # new kinds draw AFTER the legacy ones so adding them to a plan
        # shape never shifts the legacy specs of an existing seed
        if slows:
            specs += draw("slow", slows, steps=int(rng.randint(4, 10)),
                          period=int(rng.randint(2, 4)))
        if hotspots:
            specs += draw("hotspot", hotspots,
                          steps=int(rng.randint(4, 10)))
        if switch_failure is not None:
            specs.append(FaultSpec(switch_failure, switch_ordinal))
        return cls(specs)

    # -- queries (one per injection site) ---------------------------------

    def dispatch_fault(self, tick: int, replica: int) -> FaultSpec | None:
        """Crash / transient error to raise before this replica's dispatch."""
        for i, f in enumerate(self.faults):
            if f.replica != replica or tick < f.tick:
                continue
            if f.kind == "crash" and i not in self._fired:
                self._fired.add(i)
                return f
            if f.kind == "transient" and self._left.get(i, 0) > 0:
                self._left[i] -= 1
                return f
        return None

    def stalled(self, tick: int, replica: int) -> bool:
        """Is this replica frozen at this tick (no error, no progress)?

        Covers both ``stall`` (every tick in the window) and ``slow``
        (every tick in the window except each ``period``-th one, where
        the degraded replica still limps forward)."""
        for f in self.faults:
            if f.replica != replica or not f.tick <= tick < f.tick + f.steps:
                continue
            if f.kind == "stall":
                return True
            if f.kind == "slow" and (tick - f.tick) % f.period:
                return True
        return False

    def route_bias(self, tick: int) -> int | None:
        """Replica index a ``hotspot`` injection concentrates all new
        submissions on at this tick (None = no active hotspot)."""
        for f in self.faults:
            if (f.kind == "hotspot"
                    and f.tick <= tick < f.tick + f.steps):
                return f.replica
        return None

    def admit_fault(self, tick: int, replica: int) -> FaultSpec | None:
        """OOM to raise from the engine's admission path at this tick."""
        for i, f in enumerate(self.faults):
            if (f.kind == "oom" and f.replica == replica and tick >= f.tick
                    and self._left.get(i, 0) > 0):
                self._left[i] -= 1
                return f
        return None

    def switch_fault(self, ordinal: int) -> FaultSpec | None:
        """Failure to inject into the ``ordinal``-th apply_plan (1-based)."""
        for i, f in enumerate(self.faults):
            if (f.kind in ("switch_build", "switch_migrate")
                    and f.tick == ordinal and i not in self._fired):
                self._fired.add(i)
                return f
        return None

    def fired(self, kind: str) -> int:
        """How many firings of ``kind`` have happened so far (for tests)."""
        n = sum(1 for i in self._fired if self.faults[i].kind == kind)
        n += sum(self.faults[i].steps - left for i, left in self._left.items()
                 if self.faults[i].kind == kind)
        return n


def error_for(spec: FaultSpec) -> FaultError:
    """The exception a dispatch-site fault spec manifests as."""
    if spec.kind == "crash":
        return ReplicaCrash(
            f"injected crash of replica {spec.replica} (armed tick "
            f"{spec.tick}, lose_pages={spec.lose_pages})",
            lose_pages=spec.lose_pages)
    return TransientDispatchError(
        f"injected transient dispatch failure on replica {spec.replica}")
