"""Requests and Azure-Public-Dataset-like trace synthesis.

The paper evaluates on two traces sampled from real Azure LLM inference logs
(Patel et al., 2024): heterogeneous (input_len, output_len) mixes whose
composition and arrival rate drift over time (Fig. 2/8).  No real traces ship
offline, so ``synthesize_trace`` generates seeded traces with the same
qualitative structure: k workload archetypes with diurnal/shifting mixture
weights and Poisson arrivals, scaled so the cluster is neither over- nor
under-provisioned (the paper's protocol).

The port's copy of the JAX package's ``serving/request.py``: the same
seeded draws give the same traces in both packages.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Request:
    rid: int
    arrival: float          # seconds
    in_len: int
    out_len: int
    type_id: int = -1       # k-means label, filled by the clusterer
    # per-type SLO budgets (seconds; inf = unconstrained).  TTFT bounds the
    # wait + prefill; TPOT bounds the mean inter-token gap during decode —
    # the goodput / SLO-attainment metrics count only requests within both.
    ttft_budget: float = float("inf")
    tpot_budget: float = float("inf")
    # scheduling priority (higher = more important; 0 = best-effort).
    # Plumbed through ``submit`` on engine and cluster: priority orders
    # admission, and the cluster rebalancer preempts (relocates/evicts)
    # lower-priority sequences before a higher-priority request sheds.
    priority: int = 0
    # bookkeeping (simulator)
    replica: int = -1
    start: float = -1.0
    first_token: float = -1.0
    finish: float = -1.0

    @property
    def latency(self) -> float:
        return self.finish - self.arrival

    @property
    def ttft(self) -> float:
        return self.first_token - self.arrival

    @property
    def tpot(self) -> float:
        """Mean time per output token after the first."""
        return (self.finish - self.first_token) / max(self.out_len - 1, 1)

    @property
    def slo_met(self) -> bool:
        return (self.finish >= 0 and self.first_token >= 0
                and self.ttft <= self.ttft_budget
                and self.tpot <= self.tpot_budget)


def apply_slo_budgets(requests: list["Request"],
                      ttft_base: float = 10.0,
                      ttft_per_token: float = 0.01,
                      tpot_interactive: float = 0.06,
                      tpot_batch: float = 0.12,
                      interactive_out: int = 256) -> list["Request"]:
    """Attach per-type latency budgets (seeds SLO-aware admission).

    TTFT budgets scale with prompt length (prefill is paid inside them);
    TPOT budgets are tighter for short-output (interactive) types than for
    long-generation (batch-ish) ones, mirroring how serving SLOs are
    usually quoted.  Defaults sit near the calibrated simulator's p90s, so
    attainment separates policies instead of saturating at 1.0.  Returns
    the same list for chaining.
    """
    for r in requests:
        r.ttft_budget = ttft_base + ttft_per_token * r.in_len
        r.tpot_budget = (tpot_interactive if r.out_len <= interactive_out
                         else tpot_batch)
    return requests


def assign_priorities(requests: list["Request"], high_frac: float = 0.25,
                      high: int = 1, seed: int = 0) -> list["Request"]:
    """Mark a seeded fraction of requests high-priority (the priority-mix
    trace used by the rebalance benchmarks/tests).  Returns the same list
    for chaining."""
    rng = np.random.RandomState(seed)
    for r in requests:
        r.priority = high if rng.rand() < high_frac else 0
    return requests


# Archetypes roughly matching the paper's taxonomy (S2): chat / extraction
# (short out), summarization (long in, short out), generation (long out),
# reasoning/transformation (long in + long out).
ARCHETYPES = [
    {"in": (128, 0.6), "out": (128, 0.5)},     # chat
    {"in": (1536, 0.5), "out": (96, 0.5)},     # summarize / extract
    {"in": (256, 0.6), "out": (1024, 0.5)},    # generate
    {"in": (1024, 0.5), "out": (1024, 0.5)},   # transform / reason
]


def _mix_over_time(n_spans: int, trace_id: int, rng) -> np.ndarray:
    """[n_spans, K] mixture weights with trace-specific fluctuation trends."""
    t = np.arange(n_spans)
    K = len(ARCHETYPES)
    if trace_id == 1:
        # regime shift (paper Fig. 8, T1): business-hours short-task dominance
        # giving way to evening long-output dominance
        w = np.zeros((n_spans, K))
        half = n_spans // 2
        w[:half] = [0.15, 0.70, 0.05, 0.10]
        w[half:] = [0.10, 0.10, 0.45, 0.35]
        ramp = min(max(n_spans // 8, 2), half)
        for i in range(ramp):
            a = i / ramp
            w[half - ramp // 2 + i] = ((1 - a) * np.array([0.15, 0.7, 0.05, 0.1])
                                       + a * np.array([0.1, 0.1, 0.45, 0.35]))
    elif trace_id == 2:
        # fast alternation between regimes (paper T2)
        w = np.zeros((n_spans, K))
        period = max(n_spans // 5, 4)
        for s in range(n_spans):
            if (s // period) % 2 == 0:
                w[s] = [0.15, 0.65, 0.08, 0.12]
            else:
                w[s] = [0.10, 0.15, 0.40, 0.35]
    else:
        # smooth sinusoidal mixing (stress test for the predictor)
        phases = [0.0, 0.7, np.pi, np.pi + 0.6]
        period = max(n_spans / 2, 30)
        w = np.stack([1.0 + 0.75 * np.sin(2 * np.pi * t / period + ph)
                      for ph in phases], axis=1)
    w = w + 0.05 * rng.randn(n_spans, K)
    w = np.clip(w, 0.02, None)
    return w / w.sum(1, keepdims=True)


def trace_mixes(n_spans: int, trace_id: int, seed: int = 0) -> np.ndarray:
    """[n_spans, K] archetype mixture weights for a trace (deterministic)."""
    rng = np.random.RandomState(seed + 1000 * trace_id)
    return _mix_over_time(n_spans, trace_id, rng)


def synthesize_trace(n_spans: int, mean_rate: float, trace_id: int = 1,
                     seed: int = 0, span_seconds: float = 60.0,
                     rate_per_span: np.ndarray | None = None
                     ) -> list[Request]:
    """Requests over `n_spans` spans.

    ``rate_per_span`` overrides the mean rate per span — the paper scales the
    arrival rate each minute so the cluster stays neither over- nor
    under-utilized as the mix shifts (short-task regimes sustain much higher
    request rates than long-output regimes).
    """
    rng = np.random.RandomState(seed + 1000 * trace_id)
    mix = _mix_over_time(n_spans, trace_id, rng)
    envelope = 1.0 + 0.1 * np.sin(
        2 * np.pi * np.arange(n_spans) / max(n_spans / 3, 20) + trace_id)
    requests: list[Request] = []
    rid = 0
    for s in range(n_spans):
        if rate_per_span is not None:
            lam = float(rate_per_span[s]) * envelope[s]
        else:
            lam = mean_rate * envelope[s]
        n = rng.poisson(lam)
        comp = rng.choice(len(ARCHETYPES), size=n, p=mix[s])
        times = np.sort(rng.uniform(0, span_seconds, size=n))
        for i in range(n):
            a = ARCHETYPES[comp[i]]
            in_len = max(8, int(rng.lognormal(np.log(a["in"][0]), a["in"][1])))
            out_len = max(4, int(rng.lognormal(np.log(a["out"][0]), a["out"][1])))
            requests.append(Request(
                rid=rid, arrival=s * span_seconds + times[i],
                in_len=min(in_len, 8000), out_len=min(out_len, 5000)))
            rid += 1
    return requests


def span_of(req: Request, span_seconds: float = 60.0) -> int:
    return int(req.arrival // span_seconds)


def shared_prefix_prompts(n: int, prefix_len: int, unique_len: int,
                          n_templates: int = 1, vocab: int = 1000,
                          seed: int = 0) -> list[np.ndarray]:
    """Prompt token streams with heavy shared prefixes (system prompts /
    few-shot templates), the traffic shape the prefix cache exists for.

    Each prompt is one of ``n_templates`` fixed template prefixes of
    ``prefix_len`` tokens followed by a per-request unique suffix of
    ``unique_len`` tokens; requests round-robin over the templates.  With a
    warm cache only the suffix (plus the template's first pass) prefills —
    ``benchmarks/bench_prefix.py`` measures exactly that ratio.
    """
    rng = np.random.RandomState(seed)
    templates = [rng.randint(0, vocab, prefix_len).astype(np.int32)
                 for _ in range(n_templates)]
    return [np.concatenate([templates[i % n_templates],
                            rng.randint(0, vocab, unique_len).astype(np.int32)])
            for i in range(n)]
