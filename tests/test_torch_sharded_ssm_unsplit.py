"""The port's sharded SSM mixers where tp does not divide the SSM heads
(hymba-1.5b's 25 at full width): ``ssm_heads`` stays unsharded, the first
model shard holds every head, its weights and its rows, the others none,
and the greedy tokens equal the JAX package's unsharded engine's (smoke
configs with 5 and 3 SSM heads at tp 2, on ``["cpu"] * 8``).  A slot's
logical SSM rows pass unchanged through every layout: unsharded, heads
split over 2 or 4 shards, layers over 2 stages, every head on the first
shard."""
import dataclasses

import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.launch.mesh import make_replica_mesh
from repro_torch.launch.sharding import make_plan, pool_pspecs
from repro_torch.serving.kvcache import BlockPool, PagedKVCache
from test_torch_sharded_engine import DEVICES, _jax_tokens, _sharded
from test_torch_sharded_moe_ssm import _split_checks

torch.set_num_threads(1)


@pytest.mark.parametrize("arch,heads", [("hymba-1.5b", 5),
                                        ("mamba2-370m", 3)])
def test_unsplit_ssm_heads_stay_on_the_first_shard(arch, heads):
    """SSM heads that tp 2 does not divide (hymba's 25 at full width):
    ``ssm_heads`` unsharded, shard 0 holds every head and the rows, the
    other shard none, and the tokens stay JAX's."""
    want = _jax_tokens(arch, ssm_heads=heads)
    eng, plan, got = _sharded(arch, 2, 1, (("ssm_heads", heads),))
    assert plan.rules["ssm_heads"] is None
    assert eng.params.ssm_heads == [(0, heads), (heads, heads)]
    assert eng.cache.ssm.parts[0][1] is None
    assert eng.cache.ssm.parts[0][0].shape[2] == heads
    assert got == want
    _split_checks(eng, 2, 1)


def _view(cfg, tp, pp):
    if tp * pp == 1:
        return PagedKVCache.create(cfg, 8, 8, max_seqs=3, device="cpu")
    plan, _ = make_plan(cfg, "serve", False, 1, tp=tp, pp=pp)
    pool = BlockPool(cfg, 8, 8, device="cpu",
                     mesh=make_replica_mesh(DEVICES[:tp * pp], tp, pp),
                     kv_spec=pool_pspecs(cfg, plan), rules=plan.rules)
    return PagedKVCache.from_pool(pool, 3, 4)


@pytest.mark.parametrize("arch,heads", [("mamba2-370m", 4),
                                        ("hymba-1.5b", 4),
                                        ("mamba2-370m", 3)])
def test_slot_rows_pass_through_every_layout(arch, heads):
    cfg = dataclasses.replace(get_smoke_config(arch), ssm_heads=heads)
    gen = torch.Generator().manual_seed(0)
    ssm = torch.randn((cfg.n_layers, heads, cfg.ssm_head_dim,
                       cfg.ssm_state), generator=gen)
    conv = torch.randn((cfg.n_layers, cfg.ssm_conv_width - 1,
                        heads * cfg.ssm_head_dim + 2 * cfg.ssm_state),
                       generator=gen)
    rows = (ssm, conv)
    for tp, pp in ((1, 1), (2, 1), (2, 2), (4, 1), (1, 2)):
        view = _view(cfg, tp, pp)
        view.set_slot_rows(1, *rows)
        got = view.slot_rows(1)
        assert all(torch.equal(a, b) for a, b in zip(got, rows)), (tp, pp)
        # the other slots are untouched
        assert not any(t.any() for t in view.slot_rows(0))
        rows = got                      # the next layout takes these
