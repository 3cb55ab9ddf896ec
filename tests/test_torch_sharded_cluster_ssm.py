"""``test_torch_sharded_cluster_families.py``'s sharded cluster switch
against the JAX package's for the SSM family (mamba2-370m smoke: no K/V
pool, so a moved request's state is its SSM rows alone), then a crash of
the tp-2 replica and its repair onto the same chips: the switch's and the
recovery's counts field by field, the device counts and the tokens."""
import pytest
import torch

from test_torch_sharded_cluster import RECOVERY_FIELDS, _reference, _setup
from test_torch_sharded_cluster_families import check_switch, jax_cluster

torch.set_num_threads(1)

ARCH = "mamba2-370m"


@pytest.fixture(scope="module")
def jax_run():
    return jax_cluster(ARCH, crash=True)


def test_sharded_switch_moves_ssm_rows_like_jax(jax_run):
    check_switch(ARCH, jax_run)


def test_sharded_ssm_crash_and_repair_like_jax(jax_run):
    cfg, params, jobs, rt = _setup(ARCH)
    chips = rt._replica_devices[0]
    rec = rt.fail_replica(0)
    assert {f: getattr(rec, f) for f in RECOVERY_FIELDS} == \
        jax_run["recovery"]
    assert len(rt.devices) == jax_run["devices_after_fail"] == 6
    assert rt._dead_devices[0] == chips
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
