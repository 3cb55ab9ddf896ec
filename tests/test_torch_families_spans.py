"""OServe's control loop on its default model in both packages:
``run_real_spans`` defaults to opt-30b in the port as in the JAX package,
and ``run_real_spans(model="opt-30b", chips=6, n_spans=3)`` — the planner
pricing the full opt-30b on 6 chips, its smoke config (sinusoidal
positions, biases, GELU) serving — gives the JAX package's plans, switch
and span reports, shares and tokens when both serve JAX's weights (the
port's ``init_params`` replaced for the test).  fp32 on the CPU.
"""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_orchestrated_spans import outcome_fields
from torch_cluster_twins import cluster_state

import repro.models as jm
import repro.serving.validation as jval
import repro_torch.serving.validation as tval
from repro.configs import get_smoke_config as jax_smoke_config
from repro_torch import serve_orchestrated
from repro_torch.configs import get_smoke_config
from repro_torch.convert import from_jax_params


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the smoke engines compute on tiny tensors."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def real_spans():
    want = jval.run_real_spans(chips=6, n_spans=3)
    cfg = get_smoke_config("opt-30b")
    jp = jm.init_params(jax_smoke_config("opt-30b"), jax.random.PRNGKey(0),
                        jnp.float32)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), cfg, "cpu")
    mp = pytest.MonkeyPatch()
    mp.setattr(tval, "init_params", lambda cfg, seed, dtype, device: tp)
    try:
        got = tval.run_real_spans(chips=6, n_spans=3, device="cpu")
    finally:
        mp.undo()
    return got, want


def test_default_model_is_opt_30b_in_both_packages(monkeypatch):
    default = {f: inspect.signature(f.run_real_spans).parameters[
        "model"].default for f in (jval, tval)}
    assert set(default.values()) == {"opt-30b"}
    seen = []
    for mode in ("run_analytic", "run_real"):
        monkeypatch.setattr(serve_orchestrated, mode,
                            lambda args: seen.append(args.model))
    serve_orchestrated.main([])
    serve_orchestrated.main(["--real"])
    assert seen == ["opt-30b", "opt-30b"]


def test_run_real_spans_opt_30b_equals_jax(real_spans):
    (got, got_rt), (want, want_rt) = real_spans
    assert [outcome_fields(o) for o in got] == [outcome_fields(o)
                                                for o in want]
    assert cluster_state(got_rt) == cluster_state(want_rt)
    assert {rid: r.generated for rid, r in got_rt.results.items()} == {
        rid: r.generated for rid, r in want_rt.results.items()}


def test_run_real_spans_opt_30b_switches_and_completes(real_spans):
    (got, rt), _ = real_spans
    assert [str(o.plan.deployment) for o in got] == [
        "DP=3 [(TP=2), (TP=2), (TP=2)]", "DP=2 [(TP=2), (TP=4)]",
        "DP=2 [(TP=2), (TP=4)]"]
    assert [o.switch.changed for o in got[1:]] == [[1], []]
    assert got[1].switch.drained == 1 and got[1].switch.migrated == 0
    assert len(rt.results) == 18 and all(r.done for r in rt.results.values())
    assert all(np.isfinite(o.share_l1) for o in got)
