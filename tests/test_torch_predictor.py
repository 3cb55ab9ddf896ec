"""The port's workload predictor against the JAX package's.

The clustering and the baselines are numpy copies and are held exactly
equal.  The LSTM is torch in the port and JAX in the reference: on the
same weights (``convert.lstm_params_from_jax``) ``lstm_apply`` agrees within
1e-5, and ``fit`` started from JAX's initial weights (the port's
``lstm_init`` replaced for the test) follows JAX's training within 1e-4 in
every parameter and a relative 1e-4 in the loss and the predictions, fp32
on the CPU.  The port's own seeded init is held to
``tests/test_predictor.py``'s behavioural thresholds."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.predictor as jp
import repro_torch.core.predictor as tp
from repro.serving.request import span_of as jspan_of
from repro.serving.request import synthesize_trace as jsynth
from repro_torch.convert import lstm_params_from_jax
from repro_torch.serving.request import span_of, synthesize_trace

ATOL_APPLY = 1e-5
ATOL_PARAMS = 1e-4
RTOL_FIT = 1e-4


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the LSTM's products are [64, 32]-sized, so
    more threads only spin against the other test workers (a 200-epoch
    fit went from ~3 s to minutes with 8 threads on a loaded host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def trace_series(n_spans, rate=100, trace_id=2):
    """Per-span counts of ``n_spans`` spans of a synthetic trace, typed by
    k-means (k = 4): the predictor's input in ``serve_orchestrated``."""
    reqs = synthesize_trace(n_spans, rate, trace_id=trace_id, seed=0)
    il = np.array([r.in_len for r in reqs])
    ol = np.array([r.out_len for r in reqs])
    _, labels = tp.WorkloadClusterer.fit(il, ol, k=4, seed=0)
    return tp.count_series(labels, np.array([span_of(r) for r in reqs]), 4,
                           n_spans)


@pytest.fixture(scope="module")
def sin_series():
    t = np.arange(220)
    base = np.stack([50 + 30 * np.sin(2 * np.pi * t / 60),
                     25 + 10 * np.sin(2 * np.pi * t / 60 + 1.5)], axis=1)
    return np.random.RandomState(0).poisson(base).astype(float)


def jax_init(d, hidden, seed=0):
    return jax.tree.map(np.asarray, jp.lstm_init(jax.random.PRNGKey(seed),
                                                 d, hidden, d))


# --------------------------------------------------------------------------
# numpy parts: exact
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n_spans,trace_id", [(12, 1), (12, 2), (40, 3)])
def test_trace_synthesis_equal(n_spans, trace_id):
    a = jsynth(n_spans, 300, trace_id=trace_id, seed=0)
    b = synthesize_trace(n_spans, 300, trace_id=trace_id, seed=0)
    assert [vars(r) for r in b] == [vars(r) for r in a]
    assert [span_of(r) for r in b] == [jspan_of(r) for r in a]


@pytest.mark.parametrize("k,seed", [(2, 0), (4, 0), (4, 3), (7, 1)])
def test_kmeans_and_clusterer_equal(k, seed):
    rng = np.random.RandomState(seed)
    pts = np.vstack([rng.randn(60, 2) + c for c in ([0, 0], [6, 6], [0, 9])])
    for got, want in zip(tp.kmeans(pts, k, seed=seed),
                         jp.kmeans(pts, k, seed=seed)):
        np.testing.assert_array_equal(got, want)
    reqs = synthesize_trace(12, 400, trace_id=2, seed=seed)
    il = np.array([r.in_len for r in reqs])
    ol = np.array([r.out_len for r in reqs])
    tcl, tlab = tp.WorkloadClusterer.fit(il, ol, k=k, seed=seed)
    jcl, jlab = jp.WorkloadClusterer.fit(il, ol, k=k, seed=seed)
    np.testing.assert_array_equal(tlab, jlab)
    np.testing.assert_array_equal(tcl.centroids, jcl.centroids)
    np.testing.assert_array_equal(tcl.raw_centroids, jcl.raw_centroids)
    np.testing.assert_array_equal(tcl.assign(il[::3], ol[::3]),
                                  jcl.assign(il[::3], ol[::3]))
    spans = np.array([span_of(r) for r in reqs])
    np.testing.assert_array_equal(tp.count_series(tlab, spans, k, 12),
                                  jp.count_series(jlab, spans, k, 12))


def test_moving_average_and_rrmse_equal(sin_series):
    for window in (1, 5, 20):
        t = tp.MovingAveragePredictor(2, window=window)
        j = jp.MovingAveragePredictor(2, window=window)
        assert t.fit(sin_series) == j.fit(sin_series)
        np.testing.assert_array_equal(t.predict(sin_series[:70]),
                                      j.predict(sin_series[:70]))
        np.testing.assert_array_equal(t.predict_series(sin_series, start=50),
                                      j.predict_series(sin_series, start=50))
    pred = sin_series[1:] * 1.1
    assert tp.rrmse(pred, sin_series[:-1]) == jp.rrmse(pred, sin_series[:-1])
    assert tp.rrmse([1, 2, 3], [1, 2, 3]) == 0.0


# --------------------------------------------------------------------------
# the LSTM: torch against JAX on the same weights
# --------------------------------------------------------------------------


@pytest.mark.parametrize("d,hidden,T", [(1, 8, 3), (4, 8, 6), (4, 32, 50)])
def test_lstm_apply_on_converted_weights(d, hidden, T):
    init = jax_init(d, hidden, seed=d + hidden)
    # non-zero biases, so the bias terms are exercised
    rng = np.random.RandomState(T)
    init["b"] = rng.randn(*init["b"].shape).astype(np.float32) * 0.3
    init["b_out"] = rng.randn(*init["b_out"].shape).astype(np.float32)
    params = lstm_params_from_jax(init, "cpu")
    xs = rng.rand(5, T, d).astype(np.float32)
    want = np.stack([np.asarray(jp.lstm_apply(init, jnp.asarray(x)))
                     for x in xs])
    got = tp.lstm_apply(params, torch.from_numpy(xs)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_APPLY)
    # unbatched input: one sequence
    one = tp.lstm_apply(params, torch.from_numpy(xs[0])).numpy()
    np.testing.assert_allclose(one, want[0], rtol=0, atol=ATOL_APPLY)


def test_lstm_params_from_jax_checks_keys_and_shapes():
    init = jax_init(4, 8)
    with pytest.raises(ValueError, match="keys"):
        lstm_params_from_jax({k: v for k, v in init.items() if k != "b"},
                             "cpu")
    bad = dict(init, wh=np.zeros((8, 16), np.float32))
    with pytest.raises(ValueError, match="wh"):
        lstm_params_from_jax(bad, "cpu")


def fit_both(monkeypatch, series, *, window, hidden, epochs, per_type=True):
    """Fit the JAX predictor and the port's (on the CPU, from JAX's initial
    weights) on ``series``; returns both."""
    d = series.shape[1] if per_type else 1
    init = jax_init(d, hidden)
    j = jp.LSTMWorkloadPredictor(series.shape[1], window=window,
                                 hidden=hidden, per_type=per_type, seed=0)
    j.fit(series, epochs=epochs)
    monkeypatch.setattr(tp, "lstm_init", lambda gen, i, h, o, device:
                        lstm_params_from_jax(init, device))
    t = tp.LSTMWorkloadPredictor(series.shape[1], window=window,
                                 hidden=hidden, per_type=per_type, seed=0,
                                 device="cpu")
    t.fit(series, epochs=epochs)
    return j, t


def assert_fits_agree(j, t, series):
    for k in tp.LSTM_KEYS:
        np.testing.assert_allclose(t.params[k].numpy(),
                                   np.asarray(j.params[k]), rtol=0,
                                   atol=ATOL_PARAMS, err_msg=k)
    assert abs(t.train_loss - j.train_loss) <= RTOL_FIT * abs(j.train_loss)
    np.testing.assert_array_equal(t.scale, j.scale)
    # one-step predictions at eight points of the series (JAX's eager
    # ``lstm_apply`` takes ~0.1 s a call)
    ends = np.linspace(j.window, len(series), 8).astype(int)
    want = np.stack([j.predict(series[:e]) for e in ends])
    got = np.stack([t.predict(series[:e]) for e in ends])
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= RTOL_FIT * np.abs(want).max()


@pytest.mark.parametrize("n_spans,window,hidden,epochs", [
    (40, 6, 8, 40),          # serve_orchestrated's size
    (300, 50, 32, 200),      # the paper's defaults
])
def test_fit_follows_jax(monkeypatch, n_spans, window, hidden, epochs):
    series = trace_series(n_spans)
    j, t = fit_both(monkeypatch, series, window=window, hidden=hidden,
                    epochs=epochs)
    assert_fits_agree(j, t, series)


def test_aggregate_fit_follows_jax(monkeypatch, sin_series):
    j, t = fit_both(monkeypatch, sin_series[:120], window=20, hidden=16,
                    epochs=30, per_type=False)
    assert_fits_agree(j, t, sin_series[:120])
    np.testing.assert_allclose(t.predict(sin_series[:90]),
                               j.predict(sin_series[:90]),
                               rtol=RTOL_FIT, atol=0)


# --------------------------------------------------------------------------
# the port's own seeded init
# --------------------------------------------------------------------------


def test_seeded_init_is_deterministic_and_scaled():
    a = tp.lstm_init(torch.Generator().manual_seed(3), 4, 32, 4, "cpu")
    b = tp.lstm_init(torch.Generator().manual_seed(3), 4, 32, 4, "cpu")
    ref = jax_init(4, 32)
    for k in tp.LSTM_KEYS:
        assert torch.equal(a[k], b[k])
        assert a[k].dtype == torch.float32
        assert tuple(a[k].shape) == ref[k].shape
    assert float(a["b"].abs().max()) == float(a["b_out"].abs().max()) == 0.0
    # N(0, 1/sqrt(hidden)): the std of the 512 entries of wx
    assert abs(float(a["wx"].std()) * np.sqrt(32) - 1.0) < 0.15
    t1 = tp.LSTMWorkloadPredictor(4, window=6, hidden=8, device="cpu")
    t2 = tp.LSTMWorkloadPredictor(4, window=6, hidden=8, device="cpu")
    series = trace_series(30)
    assert t1.fit(series, epochs=10) == t2.fit(series, epochs=10)
    np.testing.assert_array_equal(t1.predict(series), t2.predict(series))


def test_lstm_learns_and_beats_ma(sin_series):
    lstm = tp.LSTMWorkloadPredictor(2, window=50, hidden=24, seed=0,
                                    device="cpu")
    lstm.fit(sin_series[:200], epochs=150)
    preds = lstm.predict_series(sin_series)
    true = sin_series[50:]
    r_lstm = tp.rrmse(preds[-20:], true[-20:])
    ma = tp.MovingAveragePredictor(2, window=5)
    r_ma = tp.rrmse(ma.predict_series(sin_series, start=50)[-20:],
                    true[-20:])
    assert np.isfinite(r_lstm)
    assert r_lstm < r_ma            # LSTM captures the cycle, MA lags it


@pytest.mark.parametrize("per_type", [True, False])
def test_predict_shape_and_positivity(sin_series, per_type):
    lstm = tp.LSTMWorkloadPredictor(2, window=50, hidden=16, seed=0,
                                    per_type=per_type, device="cpu")
    lstm.fit(sin_series[:200], epochs=30)
    p = lstm.predict(sin_series[:120])
    assert p.shape == (2,)
    assert (p >= 0).all()


def test_device_defaults_to_the_card():
    lstm = tp.LSTMWorkloadPredictor(2, window=4, hidden=4)
    assert lstm.device.type == "cuda"
    if not torch.cuda.is_available():
        # no fallback: without a card the default raises
        with pytest.raises((RuntimeError, AssertionError)):
            lstm.fit(np.ones((10, 2)), epochs=1)
    with pytest.raises(ValueError, match="shorter"):
        tp.LSTMWorkloadPredictor(2, window=20, device="cpu").fit(
            np.ones((10, 2)), epochs=1)
