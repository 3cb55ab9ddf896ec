"""``test_torch_sharded_cluster_families.py``'s sharded cluster switch
against the JAX package's for the hybrid family (hymba-1.5b smoke: its
attention replicated on the first shard of each replica, its SSM heads
split), counts field by field and tokens."""
import pytest
import torch

from test_torch_sharded_cluster_families import check_switch, jax_cluster

torch.set_num_threads(1)

ARCH = "hymba-1.5b"


@pytest.fixture(scope="module")
def jax_run():
    return jax_cluster(ARCH)


def test_sharded_switch_moves_hybrid_like_jax(jax_run):
    check_switch(ARCH, jax_run)
