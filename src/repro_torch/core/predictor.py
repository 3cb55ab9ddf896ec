"""Fine-grained time-series workload forecasting (paper S4.1).

Pipeline (S1/S2 in the paper):
  1. k-means over (input_len, output_len) clusters historical requests into
     workload types; per-span request counts per type form J time series.
  2. A per-type LSTM (history window = 50 spans) predicts the next span's
     arrival rate for each type.

Baselines reproduced for S5.3: a moving-average predictor and an aggregate
LSTM that forecasts the total rate without type decomposition.

The port of the JAX package's ``core/predictor.py``.  The clustering and
the baselines are numpy, copied as they are.  The LSTM is plain torch on an
explicit device (``"cuda"`` unless the caller asks for ``"cpu"``): the
JAX cell's gate order (i, f, g, o), its +1 forget bias and fp32 math, a
cell loop written out by hand (``torch.nn.LSTM`` orders and biases its
gates differently), trained by autograd with the JAX package's
self-contained Adam in the same arithmetic order and the same numpy batch
draws.  Sized so training takes seconds.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

# --------------------------------------------------------------------------
# S1: k-means workload typing.
# --------------------------------------------------------------------------


def kmeans(points: np.ndarray, k: int, iters: int = 50, seed: int = 0
           ) -> tuple[np.ndarray, np.ndarray]:
    """Lloyd's algorithm with k-means++ init.

    Args:
      points: [N, D] float array (we use D=2: in_len, out_len, log-scaled).
    Returns:
      (centroids [k, D], labels [N])
    """
    rng = np.random.RandomState(seed)
    n = len(points)
    k = min(k, n)
    # k-means++ seeding.
    centroids = [points[rng.randint(n)]]
    for _ in range(1, k):
        d2 = np.min(
            [np.sum((points - c) ** 2, axis=1) for c in centroids], axis=0)
        total = d2.sum()
        if total <= 0:
            centroids.append(points[rng.randint(n)])
            continue
        centroids.append(points[rng.choice(n, p=d2 / total)])
    C = np.array(centroids, dtype=np.float64)
    labels = np.zeros(n, dtype=np.int64)
    for _ in range(iters):
        d2 = ((points[:, None, :] - C[None, :, :]) ** 2).sum(-1)
        new_labels = d2.argmin(1)
        if np.array_equal(new_labels, labels) and _ > 0:
            break
        labels = new_labels
        for j in range(k):
            mask = labels == j
            if mask.any():
                C[j] = points[mask].mean(0)
    return C, labels


@dataclasses.dataclass
class WorkloadClusterer:
    """Maps requests -> workload type via k-means on log sequence lengths."""

    centroids: np.ndarray  # [k, 2] in log1p space
    raw_centroids: np.ndarray  # [k, 2] in token space (in_len, out_len)

    @classmethod
    def fit(cls, in_lens: np.ndarray, out_lens: np.ndarray, k: int,
            seed: int = 0) -> tuple["WorkloadClusterer", np.ndarray]:
        pts = np.stack([np.log1p(in_lens), np.log1p(out_lens)], axis=1)
        C, labels = kmeans(pts, k, seed=seed)
        raw = np.zeros_like(C)
        for j in range(len(C)):
            m = labels == j
            if m.any():
                raw[j] = [in_lens[m].mean(), out_lens[m].mean()]
            else:
                raw[j] = np.expm1(C[j])
        return cls(C, raw), labels

    @property
    def k(self) -> int:
        return len(self.centroids)

    def assign(self, in_lens: np.ndarray, out_lens: np.ndarray) -> np.ndarray:
        pts = np.stack([np.log1p(in_lens), np.log1p(out_lens)], axis=1)
        d2 = ((pts[:, None, :] - self.centroids[None, :, :]) ** 2).sum(-1)
        return d2.argmin(1)


def count_series(labels: np.ndarray, arrival_spans: np.ndarray, k: int,
                 n_spans: int) -> np.ndarray:
    """Per-span request counts per type: [n_spans, k]."""
    out = np.zeros((n_spans, k), dtype=np.float64)
    for lbl, span in zip(labels, arrival_spans):
        if 0 <= span < n_spans:
            out[int(span), int(lbl)] += 1
    return out


# --------------------------------------------------------------------------
# S2: LSTM predictor (torch).
# --------------------------------------------------------------------------

LSTM_KEYS = ("wx", "wh", "b", "w_out", "b_out")


def lstm_init(gen: torch.Generator, in_dim: int, hidden: int, out_dim: int,
              device="cuda") -> dict:
    """The JAX package's shapes and scales (normal / sqrt(hidden), zero
    biases), drawn on the host from ``gen`` so that a seed gives the same
    weights on every device, in fp32 on ``device``."""
    scale = 1.0 / np.sqrt(hidden)

    def normal(*shape):
        return (torch.randn(*shape, generator=gen, dtype=torch.float32)
                * scale).to(device)

    return {
        "wx": normal(in_dim, 4 * hidden),
        "wh": normal(hidden, 4 * hidden),
        "b": torch.zeros(4 * hidden, dtype=torch.float32, device=device),
        "w_out": normal(hidden, out_dim),
        "b_out": torch.zeros(out_dim, dtype=torch.float32, device=device),
    }


def lstm_apply(params: dict, xs: torch.Tensor) -> torch.Tensor:
    """xs: [..., T, in_dim] -> prediction [..., out_dim] from the final
    hidden state (leading dims batch independent sequences)."""
    hidden = params["wh"].shape[0]
    h = xs.new_zeros(xs.shape[:-2] + (hidden,))
    c = xs.new_zeros(xs.shape[:-2] + (hidden,))
    for t in range(xs.shape[-2]):
        z = xs[..., t, :] @ params["wx"] + h @ params["wh"] + params["b"]
        i, f, g, o = z.chunk(4, dim=-1)
        c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
    return h @ params["w_out"] + params["b_out"]


def _windows(series: np.ndarray, window: int) -> tuple[np.ndarray, np.ndarray]:
    """series [T, D] -> (X [N, window, D], Y [N, D]) next-step pairs."""
    T = len(series)
    xs, ys = [], []
    for t in range(T - window):
        xs.append(series[t:t + window])
        ys.append(series[t + window])
    return np.asarray(xs), np.asarray(ys)


class LSTMWorkloadPredictor:
    """Per-type next-span arrival-rate forecaster (paper defaults: window 50).

    ``device``: where the LSTM trains and predicts; the card unless the
    caller asks for ``"cpu"`` (without a card the default raises)."""

    def __init__(self, n_types: int, window: int = 50, hidden: int = 32,
                 per_type: bool = True, seed: int = 0, device="cuda"):
        self.n_types = n_types
        self.window = window
        self.hidden = hidden
        self.per_type = per_type  # False => aggregate baseline (no decomposition)
        self.seed = seed
        self.device = torch.device(device)
        self.params: dict | None = None
        self.scale: np.ndarray | None = None
        self.train_loss: float = float("nan")

    def _normalize(self, series: np.ndarray) -> np.ndarray:
        if self.scale is None:
            self.scale = np.maximum(series.max(axis=0), 1.0)
        return series / self.scale

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    def fit(self, series: np.ndarray, epochs: int = 200, lr: float = 1e-2,
            batch: int = 64) -> float:
        """series: [T, n_types] per-span counts. Returns final train loss."""
        if not self.per_type:
            series = series.sum(axis=1, keepdims=True)
        d = series.shape[1]
        norm = self._normalize(series)
        X, Y = _windows(norm, self.window)
        if len(X) == 0:
            raise ValueError("series shorter than prediction window")
        gen = torch.Generator().manual_seed(self.seed)
        params = lstm_init(gen, d, self.hidden, d, self.device)
        X, Y = self._tensor(X), self._tensor(Y)
        # Self-contained Adam, in the JAX package's arithmetic order.
        m = {k: torch.zeros_like(p) for k, p in params.items()}
        v = {k: torch.zeros_like(p) for k, p in params.items()}
        b1, b2, eps = 0.9, 0.999, 1e-8

        rng = np.random.RandomState(self.seed)
        n = len(X)
        t = 0
        final = float("nan")
        for _ in range(epochs):
            idx = torch.as_tensor(rng.permutation(n)[:batch],
                                  device=self.device)
            t += 1
            for p in params.values():
                p.requires_grad_(True)
            loss = torch.mean((lstm_apply(params, X[idx]) - Y[idx]) ** 2)
            grads = torch.autograd.grad(loss, list(params.values()))
            final = loss.detach()
            # bias corrections in fp32, as JAX's fp32 step count gives them
            c1 = np.float32(1.0) - np.float32(b1) ** np.float32(t)
            c2 = np.float32(1.0) - np.float32(b2) ** np.float32(t)
            with torch.no_grad():
                for (k, p), g in zip(list(params.items()), grads):
                    m[k] = b1 * m[k] + (1 - b1) * g
                    v[k] = b2 * v[k] + (1 - b2) * g * g
                    mh = m[k] / float(c1)
                    vh = v[k] / float(c2)
                    params[k] = p.detach() - lr * mh / (torch.sqrt(vh) + eps)
        self.params = params
        self.train_loss = float(final)
        return self.train_loss

    def predict(self, history: np.ndarray) -> np.ndarray:
        """history: [>=window, n_types] -> predicted next-span counts [n_types]."""
        assert self.params is not None, "call fit() first"
        h = history[-self.window:]
        if not self.per_type:
            h = h.sum(axis=1, keepdims=True)
        h = h / self.scale
        with torch.no_grad():
            pred = lstm_apply(self.params, self._tensor(h)).cpu().numpy()
        pred = np.maximum(pred * self.scale, 0.0)
        if not self.per_type:
            # Aggregate baseline: split the total by the recent type mix.
            recent = history[-self.window:].sum(axis=0)
            mix = recent / max(recent.sum(), 1.0)
            return pred[0] * mix
        return pred

    def predict_series(self, series: np.ndarray) -> np.ndarray:
        """One-step-ahead predictions over a held-out series: [T-window, n_types]."""
        out = []
        for t in range(self.window, len(series)):
            out.append(self.predict(series[:t]))
        return np.asarray(out)


class MovingAveragePredictor:
    """S5.3 baseline: mean of the last `window` spans."""

    def __init__(self, n_types: int, window: int = 5):
        self.n_types = n_types
        self.window = window

    def fit(self, series: np.ndarray, **_) -> float:
        return 0.0

    def predict(self, history: np.ndarray) -> np.ndarray:
        return history[-self.window:].mean(axis=0)

    def predict_series(self, series: np.ndarray, start: int = 50) -> np.ndarray:
        return np.asarray([self.predict(series[:t])
                           for t in range(start, len(series))])


def rrmse(pred: np.ndarray, true: np.ndarray) -> float:
    """Relative root mean squared error (paper's predictor metric)."""
    pred = np.asarray(pred, dtype=np.float64)
    true = np.asarray(true, dtype=np.float64)
    denom = max(float(np.abs(true).mean()), 1e-9)
    return float(np.sqrt(np.mean((pred - true) ** 2)) / denom)
