"""The port's sharded MoE and SSM/hybrid serving on CPU virtual devices
(``["cpu"] * 8``) against the JAX package's unsharded engine and the
port's unsharded one, on JAX's ``init_params`` weights (fp32, the zeroed
leaves perturbed so that biases, norm gains, ``conv_b`` and ``A_log``
count): greedy tokens at olmoe-1b-7b (2, 2) ("ep" experts), granite-moe
(2, 1) ("tp" experts), mamba2-370m (2, 2) and (4, 1) (one SSM head a
shard) and hymba-1.5b (2, 1); tp = pp = 1 bit-equal to the unsharded
engine, tokens and every SSM/conv row and pool page; the horizon loop;
the shards really split; the sharded forward within 1e-5 of the
unsharded one, the MoE pair also on the capacity path; more than one SSM
group over split heads raises."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import make_replica_mesh
from repro_torch.launch.sharding import (make_plan, pad_attention_params,
                                         shard_params, ssm_layout)
from repro_torch.models import forward
from repro_torch.models import moe as moe_lib
from repro_torch.models import sharded
from test_torch_sharded_engine import (DEVICES, _jax_tokens, _model,
                                       _sharded, _unsharded)

torch.set_num_threads(1)


def _split_checks(eng, tp, pp):
    """The pool rows and the weights are really split, not replicated."""
    cfg, plan, sm = eng.cfg, eng.params.plan, eng.params
    L = cfg.n_layers // pp
    for pi, mi, part in (eng.cache.ssm if cfg.has_ssm else ()):
        h0, h1 = sm.ssm_heads[mi]
        if h1 == h0:
            assert part is None                          # no heads, no rows
            continue
        assert part.shape[0] == L                        # layers over pipe
        assert part.shape[2] == h1 - h0                  # SSM heads
        conv = eng.cache.conv.parts[pi][mi]
        assert conv.shape[-1] == ((h1 - h0) * cfg.ssm_head_dim
                                  + 2 * cfg.ssm_groups * cfg.ssm_state)
        w_x = sm.shards[pi][mi]["blocks"]["ssm"]["w_x"]
        assert w_x.shape == (L, cfg.d_model, (h1 - h0) * cfg.ssm_head_dim)
        if plan.rules["ssm_heads"] == "model":
            assert h1 - h0 == cfg.ssm_heads // tp
    if cfg.is_moe:
        for pi in range(pp):
            for mi in range(tp):
                moe = sm.shards[pi][mi]["blocks"]["moe"]
                E, d, ff = moe["w_gate"].shape[1:]
                if plan.rules["experts"] == "model":
                    assert (E, ff) == (cfg.n_experts // tp, cfg.d_ff)
                else:
                    assert (E, ff) == (cfg.n_experts, cfg.d_ff // tp)
                assert moe["w_down"].shape[1:] == (E, ff, d)
                assert moe["router"].shape == (L, d, cfg.n_experts)


@pytest.mark.parametrize("arch,tp,pp,mode", [
    ("olmoe-1b-7b", 2, 2, "ep"),
    ("granite-moe-3b-a800m", 2, 1, "tp"),
    ("mamba2-370m", 2, 2, None),
    ("mamba2-370m", 4, 1, None),       # one SSM head a shard
    ("hymba-1.5b", 2, 1, None),        # attention replicated, SSM split
])
def test_families_sharded_equal_jax(arch, tp, pp, mode):
    want = _jax_tokens(arch)
    eng, plan, got = _sharded(arch, tp, pp)
    assert got == want, (arch, tp, pp)
    if mode is not None:
        assert plan.rules["experts" if mode == "ep" else "expert_ff"] == \
            "model"
    if eng.cfg.has_ssm:
        assert plan.rules["ssm_heads"] == "model"
    _split_checks(eng, tp, pp)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "granite-moe-3b-a800m",
                                  "mamba2-370m", "hymba-1.5b"])
def test_one_shard_is_bit_equal_to_unsharded(arch):
    ref_eng, ref = _unsharded(arch)
    eng, _, got = _sharded(arch, 1, 1)
    assert got == ref
    cfg = eng.cfg
    if cfg.has_ssm:
        assert torch.equal(eng.cache.ssm.parts[0][0], ref_eng.cache.ssm)
        assert torch.equal(eng.cache.conv.parts[0][0], ref_eng.cache.conv)
    if cfg.has_attn:
        for name in ("k", "v"):
            assert torch.equal(getattr(eng.cache, name).parts[0][0],
                               getattr(ref_eng.cache, name))
    assert eng.prefill_tokens == ref_eng.prefill_tokens
    assert eng.decode_syncs == ref_eng.decode_syncs


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "mamba2-370m"])
def test_horizon_keeps_parity(arch):
    want = _jax_tokens(arch)
    eng, _, got = _sharded(arch, 2, 2, decode_horizon=4)
    assert got == want
    assert max(eng.horizon_counts) == 4


def _forward_rel(arch, tp, pp, B=2, S=24, **over):
    _, _, cfg, params = _model(arch, **over)
    plan, run_cfg = make_plan(cfg, "serve", False, 1, tp=tp, pp=pp)
    if run_cfg is not cfg:
        params = pad_attention_params(params, cfg, run_cfg)
    sm = sharded.ShardedModel.build(params, run_cfg, plan,
                                    make_replica_mesh(DEVICES[:tp * pp],
                                                      tp, pp))
    tokens = torch.from_numpy(np.random.RandomState(4).randint(
        0, cfg.vocab_size, (B, S)).astype(np.int64))
    want = forward(params, run_cfg, tokens)
    got = sharded.forward(sm, run_cfg, tokens)
    assert got.shape == want.shape
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("arch,tp,pp", [
    ("olmoe-1b-7b", 2, 2), ("granite-moe-3b-a800m", 4, 1),
    ("mamba2-370m", 4, 1), ("hymba-1.5b", 2, 2)])
def test_sharded_forward_equals_unsharded(arch, tp, pp):
    """``sharded.forward`` against the unsharded ``forward`` on the same
    weights, fp32: the shards' sums round otherwise, so within 1e-5 of the
    logits' largest value."""
    rel = _forward_rel(arch, tp, pp)
    assert rel < 1e-5, rel


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "granite-moe-3b-a800m"])
def test_sharded_capacity_path_equals_unsharded(arch, monkeypatch):
    """The capacity path (B·S above ``DENSE_TOKENS``): routed and
    dispatched once, every shard keeps and drops the same (token, slot)
    pairs.  A capacity factor of 0.75 makes drops happen."""
    monkeypatch.setattr(moe_lib, "DENSE_TOKENS", 16)
    _, _, cfg, params = _model(arch, moe_capacity_factor=0.75)
    x = torch.from_numpy(np.random.RandomState(3).standard_normal(
        (4, 24, cfg.d_model)).astype(np.float32))
    p = {k: v[0] for k, v in params["blocks"]["moe"].items()}
    keep = moe_lib.dispatch(x, p, cfg)[3]
    assert not keep.all()                   # drops happen
    for tp in (2, 4):
        rel = _forward_rel(arch, tp, 1, B=4, S=24, moe_capacity_factor=0.75)
        assert rel < 1e-5, (tp, rel)


def test_ssm_groups_over_split_heads_raise():
    _, _, cfg, params = _model("mamba2-370m")
    cfg = dataclasses.replace(cfg, ssm_groups=2)
    plan, _ = make_plan(cfg, "serve", False, 1, tp=2)
    with pytest.raises(ValueError, match="ssm_groups = 2"):
        ssm_layout(cfg, plan.rules, 2)
    with pytest.raises(ValueError, match="ssm_groups = 2"):
        shard_params(params, cfg, plan, make_replica_mesh(DEVICES[:2], 2))
    # one shard holds every head: the groups are read as unsharded
    plan, _ = make_plan(cfg, "serve", False, 1, tp=1)
    assert ssm_layout(cfg, plan.rules, 1) == [(0, cfg.ssm_heads)]
