"""The port's ``serving/validation.py`` and ``serve_orchestrated`` against
the JAX package's: ``run_real_spans(model="llama2-70b", chips=6,
n_spans=3)`` — the planner switching every span with requests in flight —
gives the JAX package's plans, reports, shares and tokens when both serve
JAX's weights (the port's ``init_params`` replaced for the test); the
analytic control loop (predictor -> ``plan_span`` -> failure re-plan)
prints the JAX example's lines when both LSTMs start from JAX's weights;
and ``python -m repro_torch.serve_orchestrated --real`` runs end to end on
the CPU."""
import importlib.util
import os
import pathlib
import re
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.predictor as jpred
import repro.models as jm
import repro.serving.validation as jval
import repro_torch.core.predictor as tpred
import repro_torch.serving.validation as tval
from repro.configs import get_smoke_config as jax_smoke_config
from repro_torch import serve_orchestrated
from repro_torch.configs import get_smoke_config
from repro_torch.convert import from_jax_params, lstm_params_from_jax
from torch_cluster_twins import cluster_state, plain

ROOT = pathlib.Path(__file__).resolve().parents[1]
PLAN_FIELDS = ("deployment", "placed", "fractions", "throughput",
               "switch_seconds", "reload_seconds", "changed_replicas",
               "kv_migration_seconds")


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the LSTM and the smoke engines compute on
    tiny tensors, where more threads only spin against the other test
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def outcome_fields(o) -> dict:
    return plain({"span": o.span,
                  "plan": {f: getattr(o.plan, f) for f in PLAN_FIELDS},
                  "switch": o.switch, "report": o.report,
                  "predicted": o.predicted_share,
                  "achieved": o.achieved_share,
                  "observed": o.observed_rates, "n": o.n_requests,
                  "share_l1": o.share_l1})


@pytest.fixture(scope="module")
def real_spans():
    """Both packages' ``run_real_spans`` on llama2-70b's smoke config with
    JAX's weights (seed 0)."""
    want = jval.run_real_spans(model="llama2-70b", chips=6, n_spans=3)
    cfg = get_smoke_config("llama2-70b")
    jp = jm.init_params(jax_smoke_config("llama2-70b"),
                        jax.random.PRNGKey(0), jnp.float32)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), cfg, "cpu")
    mp = pytest.MonkeyPatch()
    mp.setattr(tval, "init_params", lambda cfg, seed, dtype, device: tp)
    try:
        got = tval.run_real_spans(model="llama2-70b", chips=6, n_spans=3,
                                  device="cpu")
    finally:
        mp.undo()
    return got, want


def test_run_real_spans_equals_jax(real_spans):
    (got, got_rt), (want, want_rt) = real_spans
    assert [outcome_fields(o) for o in got] == [outcome_fields(o)
                                                for o in want]
    assert cluster_state(got_rt) == cluster_state(want_rt)


def test_run_real_spans_switches_and_completes(real_spans):
    (got, rt), _ = real_spans
    assert [str(o.plan.deployment) for o in got] == [
        "DP=3 [(TP=2), (TP=2), (TP=2)]", "DP=2 [(TP=1, PP=2), (TP=4)]",
        "DP=2 [(TP=1, PP=3), (TP=1, PP=3)]"]
    assert all(o.switch.changed for o in got[1:])
    assert sum(o.switch.migrated for o in got) >= 1
    assert len(rt.results) == 18 and all(r.done for r in rt.results.values())
    assert all(np.isfinite(o.share_l1) for o in got)
    for o in got:
        sw = o.switch
        assert sw.migrated == sw.handoff + sw.copied + sw.reprefilled
        assert sw.copied == sw.pages_copied == sw.dropped == 0


def test_run_real_spans_shard_raises():
    with pytest.raises(NotImplementedError, match="Queue A item 9"):
        tval.run_real_spans(n_spans=1, shard=True, device="cpu")


def _jax_example():
    spec = importlib.util.spec_from_file_location(
        "jax_serve_orchestrated", ROOT / "examples" / "serve_orchestrated.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _strip_search(lines):
    return [re.sub(r" \| search [0-9.]+s$", "", ln) for ln in lines]


def test_analytic_loop_prints_the_jax_lines(monkeypatch, capsys):
    """``serve_orchestrated``'s analytic mode (12 spans, 16 chips) in both
    packages, the port's LSTM on the CPU from JAX's initial weights: the
    same per-span predictions, deployments, assignments and switch costs,
    line for line (the search's wall time aside)."""
    args = types.SimpleNamespace(model="llama2-70b", chips=16, spans=12,
                                 device="cpu")
    _jax_example().run_analytic(args)
    want = capsys.readouterr().out.splitlines()
    init = jax.tree.map(np.asarray, jpred.lstm_init(jax.random.PRNGKey(0),
                                                    4, 8, 4))
    monkeypatch.setattr(tpred, "lstm_init", lambda gen, i, h, o, device:
                        lstm_params_from_jax(init, device))
    lines = []
    out = serve_orchestrated.run_analytic(args, out=lines.append)
    assert _strip_search(lines) == _strip_search(want)
    assert len(out["plans"]) == 12 and out["window"] == 3
    assert any(p.changed_replicas for p in out["plans"][1:])


def test_serve_orchestrated_real_smoke(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    trace = tmp_path / "trace.json"
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.serve_orchestrated", "--real",
         "--spans", "2", "--device", "cpu", "--trace", str(trace)],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "total completed 12/12" in out.stdout, out.stdout
    assert "switches executed: 1" in out.stdout, out.stdout
    assert "joined decisions" in out.stdout, out.stdout
    assert trace.exists()
