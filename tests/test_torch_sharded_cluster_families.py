"""The port's ``ClusterRuntime(shard=True)`` against the JAX package's for
the MoE family: ``tests/test_sharded_engine.py``'s ``CLUSTER_SCRIPT`` with
its model set to olmoe-1b-7b (smoke, fp32, 8 virtual chips, the switch
from (tp2)+(tp1) to (tp1)+(tp2, pp2) with ``drain_steps=0``, so every
in-flight sequence moves by ``reshard_blocks``).  One JAX subprocess with
8 forced host devices prints the ``SwitchReport`` fields and tokens; the
port runs the same scenario in process on JAX's weights: the counts equal
JAX's field by field, nothing is re-prefilled or recomputed, and the
tokens equal JAX's and the port's unsharded engine's.  The SSM and hybrid
families' twins (``test_torch_sharded_cluster_ssm.py``,
``..._hybrid.py``) share this file's drivers."""
import json
import os
import subprocess
import sys

import pytest
import torch

import test_sharded_engine as jax_sharded
from repro_torch.core.types import ReplicaConfig
from test_torch_sharded_cluster import (JAX_TAIL, REPORT_FIELDS, PlanStub,
                                        _reference, _setup)

torch.set_num_threads(1)

# the switch alone, where no crash round follows
SWITCH_TAIL = r"""
import json
out = {"switch": {f: getattr(sw, f) for f in %r},
       "tokens": {str(i): list(map(int, rt.results[i].generated))
                  for i in range(6)}}
print("JSON" + json.dumps(out))
""" % (REPORT_FIELDS,)


def jax_cluster(arch: str, crash: bool = False) -> dict:
    """``CLUSTER_SCRIPT`` with its model set to ``arch`` in a JAX
    subprocess with 8 host devices: its switch's fields and tokens, and
    with ``crash`` the crash-and-repair round's (``JAX_TAIL``)."""
    body = jax_sharded.CLUSTER_SCRIPT.replace(
        'get_smoke_config("yi-9b")', f'get_smoke_config("{arch}")')
    assert arch in body
    script = body.replace('print("CLUSTER_OK")',
                          JAX_TAIL if crash else SWITCH_TAIL)
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    r = subprocess.run([sys.executable, "-c", script], env=env,
                       capture_output=True, text=True, timeout=600,
                       cwd=os.path.dirname(os.path.dirname(__file__)))
    assert r.returncode == 0, r.stderr[-3000:]
    line = [x for x in r.stdout.splitlines() if x.startswith("JSON")][0]
    return json.loads(line[4:])


def check_switch(arch: str, want: dict) -> None:
    """The port's switch on ``arch``: JAX's counts field by field, every
    request in flight moved by reshard (an SSM model's with its rows),
    nothing re-prefilled, JAX's and the unsharded engine's tokens."""
    cfg, params, jobs, rt = _setup(arch)
    sw = rt.apply_plan(PlanStub([ReplicaConfig(1, 1), ReplicaConfig(2, 2)],
                                [[0.25], [0.75]]))
    assert sw.changed == [0, 1]
    assert sw.copied == sw.migrated >= 3, sw
    assert sw.reprefilled == sw.recompute_tokens == 0
    assert {f: getattr(sw, f) for f in REPORT_FIELDS} == want["switch"]
    eng = rt.replicas[1].engine
    if cfg.has_ssm:
        # the (tp2, pp2) replica's SSM rows are split four ways
        heads = cfg.ssm_heads // 2
        assert [tuple(t.shape[::2]) for _, _, t in eng.cache.ssm] == \
            [(1, heads, cfg.ssm_state)] * 4
    rt.run_until_idle()
    assert len(rt.results) == 6
    assert rt.total_prefill_tokens == sum(len(p) for p, _ in jobs.values())
    got = {i: rt.results[i].generated for i in range(6)}
    assert got == _reference(cfg, params, jobs)
    assert {str(i): t for i, t in got.items()} == want["tokens"]


ARCH = "olmoe-1b-7b"


@pytest.fixture(scope="module")
def jax_run():
    return jax_cluster(ARCH)


def test_sharded_switch_moves_moe_like_jax(jax_run):
    check_switch(ARCH, jax_run)
