"""The port's ``ClusterRuntime(shard=True)`` against the JAX package's: the
twin of ``tests/test_sharded_engine.py``'s ``CLUSTER_SCRIPT`` (yi-9b smoke,
fp32, 8 virtual chips, the switch from (tp2)+(tp1) to (tp1)+(tp2, pp2)
with ``drain_steps=0``, so every in-flight sequence moves by
``reshard_blocks``), plus one crash of the tp-2 replica and its repair.

JAX needs 8 host devices, which only a fresh process gets
(``XLA_FLAGS``), so one subprocess per module runs the JAX script, which
asserts what it asserts, and prints its ``SwitchReport``, its recovery
report, its device counts and its tokens; the port runs the same scenario
in process on JAX's weights and must assert the same and print the same.
A MoE and a hybrid model are served through the same switch
(``test_torch_sharded_cluster_families.py`` holds them against JAX's
counts)."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import test_sharded_engine as jax_sharded
from repro_torch.core.types import Deployment, ReplicaConfig
from repro_torch.serving.cluster import ClusterRuntime
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.router import FlowRouter
from torch_cluster_twins import weights

torch.set_num_threads(1)

REPORT_FIELDS = ("changed", "drained", "migrated", "requeued", "handoff",
                 "copied", "reprefilled", "pages_handoff", "pages_copied",
                 "recompute_tokens", "dropped", "rolled_back")
RECOVERY_FIELDS = ("handoff", "copied", "reprefilled", "requeued",
                   "pages_handoff", "pages_copied", "recompute_tokens",
                   "dropped")

# appended to the JAX script in place of its last line: the crash and
# repair round, then everything as one JSON line
JAX_TAIL = r"""
import json
sw_fields = %r
rec_fields = %r
out = {"switch": {f: getattr(sw, f) for f in sw_fields},
       "tokens": {str(i): list(map(int, rt.results[i].generated))
                  for i in range(6)}}
rt = ClusterRuntime(cfg, params, total_chips=8, blocks_per_chip=16,
                    seqs_per_chip=2, block_size=8, drain_steps=0,
                    router=FlowRouter([[0.5], [0.5]]), shard=True)
rt.apply_plan(PlanStub([ReplicaConfig(2, 1), ReplicaConfig(1, 1)],
                       [[0.5], [0.5]]))
for i in range(6):
    rt.submit(i, *jobs[i])
for _ in range(3):
    rt.step()
rec = rt.fail_replica(0)
out["recovery"] = {f: getattr(rec, f) for f in rec_fields}
out["devices_after_fail"] = len(rt.devices)
rt.repair_replica(0)
out["devices_after_repair"] = len(rt.devices)
out["repaired_mesh"] = int(rt.replicas[0].engine._mesh.devices.size)
rt.run_until_idle()
out["crash_tokens"] = {str(i): list(map(int, rt.results[i].generated))
                       for i in range(6)}
out["crash_prefill_tokens"] = rt.total_prefill_tokens
print("JSON" + json.dumps(out))
""" % (REPORT_FIELDS, RECOVERY_FIELDS)


@pytest.fixture(scope="module")
def jax_run():
    script = jax_sharded.CLUSTER_SCRIPT.replace('print("CLUSTER_OK")',
                                                JAX_TAIL)
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    r = subprocess.run([sys.executable, "-c", script], env=env,
                       capture_output=True, text=True, timeout=600,
                       cwd=os.path.dirname(os.path.dirname(__file__)))
    assert r.returncode == 0, r.stderr[-3000:]
    line = [x for x in r.stdout.splitlines() if x.startswith("JSON")][0]
    return json.loads(line[4:])


class PlanStub:
    def __init__(self, rcs, fractions):
        self.deployment = Deployment(tuple(rcs))
        self.fractions = fractions


def _setup(arch="yi-9b"):
    _, _, cfg, params = weights(arch)
    rng = np.random.RandomState(0)
    jobs = {i: (rng.randint(0, cfg.vocab_size,
                            8 + 4 * (i % 2)).astype(np.int32), 7 + i % 3)
            for i in range(6)}
    rt = ClusterRuntime(cfg, params, total_chips=8, blocks_per_chip=16,
                        seqs_per_chip=2, block_size=8, drain_steps=0,
                        router=FlowRouter([[0.5], [0.5]]), shard=True,
                        device="cpu")
    rt.apply_plan(PlanStub([ReplicaConfig(2, 1), ReplicaConfig(1, 1)],
                           [[0.5], [0.5]]))
    for i in range(6):
        rt.submit(i, *jobs[i])
    for _ in range(3):
        rt.step()                       # leave every request in flight
    return cfg, params, jobs, rt


def _reference(cfg, params, jobs):
    ref = ServingEngine(cfg, params, num_blocks=256, block_size=8,
                        max_seqs=8, device="cpu")
    for i, (p, n) in jobs.items():
        ref.submit(i, p, n)
    return {r.rid: r.generated for r in ref.run_to_completion()}


def test_sharded_switch_reshards_pages_like_jax(jax_run):
    cfg, params, jobs, rt = _setup()
    assert rt.devices == [torch.device("cpu")] * 8
    meshes = [h.engine._mesh for h in rt.replicas]
    assert meshes[0].devices.size == 2 and meshes[1].devices.size == 1
    # virtual chips on one device: the slices differ by chip id
    assert not set(meshes[0].chips) & set(meshes[1].chips)
    sw = rt.apply_plan(PlanStub([ReplicaConfig(1, 1), ReplicaConfig(2, 2)],
                                [[0.25], [0.75]]))
    assert sw.changed == [0, 1]
    assert sw.migrated >= 3, sw
    assert sw.copied >= 3 and sw.reprefilled == 0, sw
    assert sw.recompute_tokens == 0
    assert sw.pages_copied > 0
    assert {f: getattr(sw, f) for f in REPORT_FIELDS} == jax_run["switch"]
    # the new (tp2, pp2) replica's pool is split four ways
    parts = [tuple(k.shape) for _, _, k in rt.replicas[1].engine.cache.k]
    assert parts == [(1, 16 * 4 + 1, 1, 8, cfg.head_dim)] * 4
    rt.run_until_idle()
    assert len(rt.results) == 6
    assert rt.total_prefill_tokens == sum(len(p) for p, _ in jobs.values())
    expected = _reference(cfg, params, jobs)
    got = {i: rt.results[i].generated for i in range(6)}
    assert got == expected
    assert {str(i): t for i, t in got.items()} == jax_run["tokens"]


def test_sharded_crash_and_repair_restore_the_slice(jax_run):
    cfg, params, jobs, rt = _setup()
    chips = rt._replica_devices[0]
    rec = rt.fail_replica(0)
    assert {f: getattr(rec, f) for f in RECOVERY_FIELDS} == \
        jax_run["recovery"]
    assert len(rt.devices) == jax_run["devices_after_fail"] == 6
    assert rt._dead_devices[0] == chips
    assert not set(chips) & set(rt._chips)
    rt.repair_replica(0)
    assert len(rt.devices) == jax_run["devices_after_repair"] == 8
    assert rt.replicas[0].engine._mesh.chips == chips
    assert rt.replicas[0].engine._mesh.devices.size == \
        jax_run["repaired_mesh"]
    rt.run_until_idle()
    got = {str(i): rt.results[i].generated for i in range(6)}
    assert got == jax_run["crash_tokens"]
    assert rt.total_prefill_tokens == jax_run["crash_prefill_tokens"]
    assert {int(i): t for i, t in got.items()} == _reference(cfg, params,
                                                             jobs)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "hymba-1.5b"])
def test_sharded_runtime_serves_moe_and_ssm(arch):
    """``ClusterRuntime(shard=True)`` serves a MoE and a hybrid model to
    completion across the switch, with the unsharded engine's tokens."""
    cfg, params, jobs, rt = _setup(arch)
    sw = rt.apply_plan(PlanStub([ReplicaConfig(1, 1), ReplicaConfig(2, 2)],
                                [[0.25], [0.75]]))
    assert sw.reprefilled == sw.recompute_tokens == 0 and sw.copied >= 3
    rt.run_until_idle()
    assert {i: rt.results[i].generated for i in range(6)} == \
        _reference(cfg, params, jobs)
