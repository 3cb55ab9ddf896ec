"""Paper Fig. 6 + S5.3 predictor study: per-type LSTM vs MA vs aggregate LSTM.

The twin of ``benchmarks/bench_predictor.py``.  Reports held-out RRMSE per
method (paper: LSTM ~5%, MA ~43%, aggregate ~40%) and prediction wall time
(paper: <30 ms per prediction).  The LSTMs train and predict on
``device``: the card unless ``"cpu"`` is asked for.
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.core.predictor import (LSTMWorkloadPredictor,
                                        MovingAveragePredictor,
                                        WorkloadClusterer, count_series,
                                        rrmse)
from repro_torch.serving.request import span_of, synthesize_trace


def study(n_spans: int = 300, k: int = 4, epochs: int = 250,
          device="cuda") -> dict:
    """The three predictors on a ``synthesize_trace`` of ``n_spans`` spans
    typed by k-means, trained on the first 90 % and scored on the rest:
    ``rrmse`` by method (``lstm``, ``ma``, ``agg``), the per-type fit's
    seconds (``fit_s``) and milliseconds per prediction (``pred_ms``),
    both on the host clock around synchronous calls."""
    reqs = synthesize_trace(n_spans, 400, trace_id=3, seed=0)
    il = np.array([r.in_len for r in reqs])
    ol = np.array([r.out_len for r in reqs])
    cl, _ = WorkloadClusterer.fit(il, ol, k, seed=0)
    labels = cl.assign(il, ol)
    series = count_series(labels, np.array([span_of(r) for r in reqs]),
                          k, n_spans)
    split = int(0.9 * n_spans)      # paper: 90/10 train/test

    lstm = LSTMWorkloadPredictor(k, window=50, hidden=32, seed=0,
                                 device=device)
    t0 = time.time()
    lstm.fit(series[:split], epochs=epochs)     # returns a host float
    fit_s = time.time() - t0
    t0 = time.time()
    preds = lstm.predict_series(series)         # each copied to the host
    pred_ms = (time.time() - t0) / max(len(series) - 50, 1) * 1e3
    r = rrmse(preds[split - 50:], series[split:])

    ma = MovingAveragePredictor(k, window=5)
    r_ma = rrmse(ma.predict_series(series, start=50)[split - 50:],
                 series[split:])

    agg = LSTMWorkloadPredictor(k, window=50, hidden=32, per_type=False,
                                seed=0, device=device)
    agg.fit(series[:split], epochs=epochs)
    r_agg = rrmse(agg.predict_series(series)[split - 50:], series[split:])
    return {"lstm": r, "ma": r_ma, "agg": r_agg, "fit_s": fit_s,
            "pred_ms": pred_ms}


def rows(s: dict) -> list[str]:
    """``study``'s numbers as the JAX benchmark's rows."""
    r, r_ma, r_agg = s["lstm"], s["ma"], s["agg"]
    return [
        f"predictor/lstm-per-type,{s['pred_ms']*1e3:.0f},"
        f"rrmse={100*r:.2f}%;fit={s['fit_s']:.1f}s;pred={s['pred_ms']:.1f}ms",
        f"predictor/moving-average,0,rrmse={100*r_ma:.2f}%",
        f"predictor/lstm-aggregate,0,rrmse={100*r_agg:.2f}%",
        f"predictor/ordering,0,"
        f"per_type<{'MA' if r < r_ma else 'FAIL'};"
        f"per_type<{'agg' if r < r_agg else 'FAIL'}"]


def main(fast: bool = True, n_spans: int = 300, k: int = 4,
         epochs: int = 250, device="cuda") -> list[str]:
    return rows(study(n_spans, k, epochs, device))


if __name__ == "__main__":
    for r in main():
        print(r)
