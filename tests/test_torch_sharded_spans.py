"""``run_real_spans(shard=True)`` and ``serve_orchestrated --real --shard``
on the port against the JAX package's: llama2-70b's smoke config planned
on 6 chips over 3 spans, each replica's (tp, pp) executed on a sub-mesh of
its own chips (6 host devices for JAX in a subprocess, 6 virtual chips on
the CPU for the port) on JAX's weights: the same deployments, switch
reports, per-replica tokens and finished streams."""
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as jm
import repro_torch.serving.validation as tval
from repro.configs import get_smoke_config as jax_smoke_config
from repro_torch.configs import get_smoke_config
from repro_torch.convert import from_jax_params

ROOT = pathlib.Path(__file__).resolve().parents[1]
SWITCH_FIELDS = ("changed", "drained", "migrated", "requeued", "handoff",
                 "copied", "reprefilled", "pages_handoff", "pages_copied",
                 "recompute_tokens", "dropped", "rolled_back")

JAX_SCRIPT = r"""
import json
from repro.serving.validation import run_real_spans
fields = %r
outs, rt = run_real_spans(model="llama2-70b", chips=6, n_spans=3,
                          shard=True)
print("JSON" + json.dumps({
    "spans": [{"deployment": str(o.plan.deployment),
               "switch": {f: getattr(o.switch, f) for f in fields},
               "tokens": [int(t) for t in o.report.tokens]}
              for o in outs],
    "results": {str(r): [int(t) for t in q.generated]
                for r, q in rt.results.items()},
    "prefill_tokens": int(rt.total_prefill_tokens)}))
""" % (SWITCH_FIELDS,)


@pytest.fixture(scope="module")
def runs():
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=6")
    r = subprocess.run([sys.executable, "-c", JAX_SCRIPT], env=env,
                       capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    line = [x for x in r.stdout.splitlines() if x.startswith("JSON")][0]
    want = json.loads(line[4:])

    cfg = get_smoke_config("llama2-70b")
    jp = jm.init_params(jax_smoke_config("llama2-70b"),
                        jax.random.PRNGKey(0), jnp.float32)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), cfg, "cpu")
    mp = pytest.MonkeyPatch()
    mp.setattr(tval, "init_params", lambda cfg, seed, dtype, device: tp)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        outs, rt = tval.run_real_spans(model="llama2-70b", chips=6,
                                       n_spans=3, shard=True, device="cpu")
    finally:
        mp.undo()
        torch.set_num_threads(n)
    got = {
        "spans": [{"deployment": str(o.plan.deployment),
                   "switch": {f: getattr(o.switch, f)
                              for f in SWITCH_FIELDS},
                   "tokens": [int(t) for t in o.report.tokens]}
                  for o in outs],
        "results": {str(r): [int(t) for t in q.generated]
                    for r, q in rt.results.items()},
        "prefill_tokens": int(rt.total_prefill_tokens)}
    return got, want, rt


def test_sharded_spans_equal_jax(runs):
    got, want, _ = runs
    assert got == want


def test_sharded_spans_switch_by_reshard(runs):
    got, _, rt = runs
    assert [s["deployment"] for s in got["spans"]] == [
        "DP=3 [(TP=2), (TP=2), (TP=2)]", "DP=2 [(TP=1, PP=2), (TP=4)]",
        "DP=2 [(TP=1, PP=3), (TP=1, PP=3)]"]
    assert len(rt.results) == 18
    moved = [s["switch"] for s in got["spans"][1:]]
    assert all(sw["changed"] for sw in moved)
    # per-replica pools: every page-bearing move is a copy (reshard),
    # never a handoff, and nothing is recomputed
    assert sum(sw["copied"] for sw in moved) >= 1
    assert all(sw["handoff"] == sw["reprefilled"] == 0 for sw in moved)
    assert all(sw["recompute_tokens"] == 0 for sw in moved)
    assert rt.pool is None and len(rt.devices) == 6
    # a (tp 1, pp 3) replica of a 2-layer model: layers do not divide pp,
    # so the first stage keeps both and the pool's layer axis is whole
    eng = rt.replicas[0].engine
    assert eng.params.layers == [(0, 2), (2, 2), (2, 2)]


def test_serve_orchestrated_shard_smoke():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.serve_orchestrated", "--real",
         "--shard", "--spans", "2", "--device", "cpu", "--model",
         "llama2-70b", "--chips", "6"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert ("llama2-70b-smoke (sharded engines, cpu) planning as "
            "llama2-70b on 6 chips" in out.stdout), out.stdout
    assert "total completed 12/12" in out.stdout, out.stdout
    assert "switches executed: 1" in out.stdout, out.stdout
