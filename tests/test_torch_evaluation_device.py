"""The evaluation twins with device work, on the CPU against the JAX
package: ``bench_predictor`` (the LSTMs), ``OServePolicy`` with the LSTM
in the loop, and ``bench_e2e.real_validation`` (the control loop's plans
on the port's engines).

The port's LSTM starts from JAX's initial weights here
(``convert.lstm_params_from_jax`` in place of ``lstm_init``), and the
real engines serve JAX's weights (``convert.from_jax_params`` in place of
``init_params``); from its own seeded init the port is held to
``tests/test_system.py``'s invariants (``tests/test_torch_system.py``).
The LSTM's fp32 arithmetic follows JAX's within 1e-4, not to the bit, so
the predictor's rrmse and the predictions in the loop are compared within
1e-4 (``tests/test_torch_predictor.py`` sets that bound); everything else
is compared with ``==``."""
import copy
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_simulator import N_SPANS, PACKAGES, setup, sim_fields
from torch_cluster_twins import chip_smoke

import benchmarks.bench_e2e as je2e
import benchmarks.bench_predictor as jbench_predictor
import repro.core.predictor as jpred
import repro.models as jm
import repro_torch.benchmarks.bench_predictor as tbench_predictor
import repro_torch.core.predictor as tpred
import repro_torch.serving.validation as tval
from repro.configs import get_smoke_config as jax_smoke_config
from repro_torch.configs import get_smoke_config
from repro_torch.convert import from_jax_params, lstm_params_from_jax

RTOL_LSTM = 1e-4


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the LSTM's products are [64, 32]-sized."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_weights(monkeypatch):
    """The port's ``lstm_init`` replaced by JAX's initial weights for the
    same seed and shapes."""
    def init(gen, in_dim, hidden, out_dim, device):
        p = jpred.lstm_init(jax.random.PRNGKey(0), in_dim, hidden, out_dim)
        return lstm_params_from_jax(jax.tree.map(np.asarray, p), device)
    monkeypatch.setattr(tpred, "lstm_init", init)


def rrmse_of(rows) -> dict:
    return {row.split(",")[0]: float(re.search(r"rrmse=([0-9.]+)%",
                                               row).group(1)) / 100
            for row in rows if "rrmse=" in row}


def test_predictor_rows_follow_jax(monkeypatch):
    """``bench_predictor.main(n_spans=120, epochs=20)``: the moving
    average's row equal, the two LSTMs' rrmse within 1e-4, the ordering
    row equal.  JAX's ``predict`` runs ``lstm_apply`` eagerly (~0.17 s a
    call, 140 calls), so the JAX side runs it under ``jax.jit``: the same
    function, compiled once."""
    monkeypatch.setattr(jpred, "lstm_apply", jax.jit(jpred.lstm_apply))
    want = jbench_predictor.main(n_spans=120, epochs=20)
    jax_weights(monkeypatch)
    got = tbench_predictor.main(n_spans=120, epochs=20, device="cpu")
    assert [r.split(",")[0] for r in got] == [r.split(",")[0] for r in want]
    assert got[1] == want[1] and got[3] == want[3]
    g, w = rrmse_of(got), rrmse_of(want)
    assert g.keys() == w.keys() and len(g) == 3
    for k in g:
        # the rows print a percentage to two decimals: 1e-4 of a fraction
        assert abs(g[k] - w[k]) <= RTOL_LSTM + 1e-12, (k, g[k], w[k])
    assert re.fullmatch(r"rrmse=[0-9.]+%;fit=[0-9.]+s;pred=[0-9.]+ms",
                        got[0].split(",", 2)[2])


def test_oserve_with_the_lstm_in_the_loop_follows_jax(monkeypatch):
    """``OServePolicy`` with an ``LSTMWorkloadPredictor(window=3,
    hidden=8)`` fitted on the first spans' counts + 1 for 20 epochs, on
    ``tests/test_serving.py``'s 6-span trace: the LSTM is asked at spans
    3-5 (the history must exceed the window).  Each prediction is within
    1e-4 of JAX's; the planner then makes the same decisions, so the
    deployment log, the drops and every request's times are equal."""
    got, preds = {}, {}
    jax_weights(monkeypatch)
    for pkg in PACKAGES:
        cm, cluster, arch, reqs = setup(pkg)
        counts = np.zeros((N_SPANS, len(arch)))
        for r in reqs:
            counts[min(int(r.arrival // 60.0), N_SPANS - 1), r.type_id] += 1
        mod = jpred if pkg == "jax" else tpred
        kw = {} if pkg == "jax" else {"device": "cpu"}
        lstm = mod.LSTMWorkloadPredictor(len(arch), window=3, hidden=8,
                                         seed=0, **kw)
        lstm.fit(counts[:5] + 1.0, epochs=20)
        seen = []
        predict = lstm.predict
        lstm.predict = (lambda h, _p=predict, _s=seen:
                        _s.append(_p(h)) or _s[-1])
        base, sim = PACKAGES[pkg][3], PACKAGES[pkg][5]
        pol = base.OServePolicy(cm, cluster, arch, predictor=lstm)
        res = sim.simulate(copy.deepcopy(reqs), pol, cm, arch, N_SPANS)
        got[pkg], preds[pkg] = sim_fields(pol, res), np.asarray(seen)
    assert preds["torch"].shape == preds["jax"].shape == (3, 4)
    np.testing.assert_allclose(preds["torch"], preds["jax"], rtol=RTOL_LSTM,
                               atol=0)
    assert got["torch"] == got["jax"]


# --------------------------------------------------------------------------
# real_validation: the control loop's plans on the engines (opt-30b smoke)
# --------------------------------------------------------------------------


def test_real_validation_rows_equal_jax(monkeypatch):
    """The rows of ``chip_smoke.py``'s phase-4 check (``real_validation``
    on opt-30b smoke, 6 chips, 2 spans) equal the JAX benchmark's but for
    the wall-clock fields, on JAX's weights."""
    want = je2e.real_validation(n_spans=2)
    jp = jm.init_params(jax_smoke_config("opt-30b"), jax.random.PRNGKey(0),
                        jnp.float32)
    tp = from_jax_params(jax.tree.map(np.asarray, jp),
                         get_smoke_config("opt-30b"), "cpu")
    monkeypatch.setattr(tval, "init_params",
                        lambda cfg, seed, dtype, device: tp)
    cs = chip_smoke()
    got, fields = cs.real_validation_rows("cpu")
    assert fields == cs.timeless_rows(want)
    names = [r.split(",")[0].rsplit("/", 1)[1] for r in got]
    assert names == ["span0", "span1", "total", "ttft_s", "tpot_s",
                     "queue_delay_s", "calibration"]
    assert "completed=12/12;switches=1" in got[2]
