"""Shared benchmark harness: trace setup, calibration, policy table.

The twin of ``benchmarks/common.py``.  The port prices the paper's H100
cluster only (``core/types.py`` holds no TPU spec), so ``hw`` takes
``"h100"``; with it, every field of a ``Bench`` equals the JAX package's.
"""
from __future__ import annotations

import copy
import time

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core.costmodel import CostModel
from repro_torch.core.predictor import WorkloadClusterer, count_series
from repro_torch.core.types import H100_SPEC, ClusterSpec, WorkloadType
from repro_torch.serving.baselines import calibrate_rate
from repro_torch.serving.request import (apply_slo_budgets, span_of,
                                         synthesize_trace)
from repro_torch.serving.simulator import simulate

HW = {"h100": H100_SPEC}


class Bench:
    """One calibrated (model, cluster, trace) experiment context."""

    def __init__(self, model: str = "opt-30b", chips: int = 16,
                 n_spans: int = 40, trace_id: int = 1, k_types: int = 4,
                 utilization: float = 0.95, seed: int = 0, hw: str = "h100"):
        if hw not in HW:
            raise ValueError(f"hw={hw!r}: the port prices the H100 only "
                             f"(choices {sorted(HW)}); it copies no TPU spec")
        self.cfg = get_config(model)
        self.cm = CostModel(self.cfg.profile(), hw=HW[hw])
        self.cluster = ClusterSpec(chips, hw=HW[hw])
        self.n_spans = n_spans
        self.trace_id = trace_id

        probe = synthesize_trace(n_spans, 100, trace_id, seed)
        il = np.array([r.in_len for r in probe])
        ol = np.array([r.out_len for r in probe])
        self.clusterer, labels = WorkloadClusterer.fit(il, ol, k_types, seed)
        self.archetypes = [WorkloadType(int(c[0]), int(c[1]))
                           for c in self.clusterer.raw_centroids]
        # Paper protocol: per-span arrival rates track the mix-dependent
        # cluster capacity (neither over- nor under-utilized at any time).
        probe_spans = np.array([span_of(r) for r in probe])
        probe_labels = self.clusterer.assign(il, ol)
        pc = count_series(probe_labels, probe_spans, k_types, n_spans)
        mixes = pc / np.maximum(pc.sum(1, keepdims=True), 1)
        # calibrate capacity on a handful of anchor mixes, interpolate by
        # nearest anchor (searches are the expensive part)
        anchors = [0, n_spans // 4, n_spans // 2, 3 * n_spans // 4,
                   n_spans - 1]
        caps = {}
        for a in anchors:
            caps[a] = calibrate_rate(self.cm, chips, self.archetypes,
                                     mixes[a], utilization=utilization)
        rate_per_span = np.array([
            caps[min(anchors, key=lambda a: np.abs(mixes[a] - mixes[s]).sum())]
            for s in range(n_spans)])
        self.rate = float(rate_per_span.mean())
        self.requests = synthesize_trace(n_spans, self.rate, trace_id, seed,
                                         rate_per_span=rate_per_span)
        il = np.array([r.in_len for r in self.requests])
        ol = np.array([r.out_len for r in self.requests])
        self.labels = self.clusterer.assign(il, ol)
        self.counts = count_series(
            self.labels, np.array([span_of(r) for r in self.requests]),
            k_types, n_spans)
        self.avg_rates = self.counts.mean(0)

    def tagged_requests(self):
        rs = copy.deepcopy(self.requests)
        for r, l in zip(rs, self.labels):
            r.type_id = int(l)
        return apply_slo_budgets(rs)

    def run(self, policy, queue_cap: float = 240.0):
        t0 = time.time()
        res = simulate(self.tagged_requests(), policy, self.cm,
                       self.archetypes, self.n_spans,
                       queue_cap_seconds=queue_cap)
        m = res.metrics()
        m["sim_seconds"] = time.time() - t0
        return res, m


def csv_row(name: str, us_per_call: float, derived: str) -> str:
    return f"{name},{us_per_call:.3f},{derived}"
