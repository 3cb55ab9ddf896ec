"""The port's sharded ``ServingEngine`` on CPU virtual devices
(``["cpu"] * 8``) against the JAX package's unsharded engine and the port's
unsharded one, on the same weights (JAX ``init_params``, fp32):
``tests/test_sharded_engine.py``'s parity jobs at (tp, pp) in {(1, 1),
(2, 1), (1, 2), (2, 2)}, with the horizon loop and chunked prefill; tp =
pp = 1 bit-equal to unsharded (tokens and pools); the shards really split
(pool layers L/pp, KV heads Hkv/tp, ``wq`` 1/tp as wide); the MHA "pad"
case at tp = 4; the replicated-KV case (tp = 4 over 2 KV heads);
"replicate" mode; dense archs with MLP biases (the once-only ``b_down``),
sandwich norms and softcaps; the sharded full-sequence forward within
1e-5 of the unsharded one; MoE and SSM/hybrid replicas equal to the
unsharded engine."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as jm
from repro.configs import get_smoke_config as jax_smoke_config
from repro.serving.engine import ServingEngine as JaxEngine
from repro_torch.configs import get_smoke_config
from repro_torch.convert import from_jax_params
from repro_torch.launch.mesh import make_replica_mesh
from repro_torch.launch.sharding import (make_plan, pad_attention_params,
                                         pool_pspecs)
from repro_torch.models import forward
from repro_torch.models import sharded
from repro_torch.serving.engine import ServingEngine

torch.set_num_threads(1)

DEVICES = ["cpu"] * 8


@functools.lru_cache(maxsize=None)
def _model(arch, **over):
    jcfg = dataclasses.replace(jax_smoke_config(arch), **over)
    cfg = dataclasses.replace(get_smoke_config(arch), **over)
    jp = jm.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    # perturb the leaves JAX's init zeroes (biases, norm gains) so that
    # every one of them counts
    leaves, tree = jax.tree.flatten(jp)
    rng = np.random.RandomState(7)
    leaves = [jnp.asarray(np.asarray(x) + 0.02 * rng.standard_normal(
        x.shape).astype(np.float32)) if not np.asarray(x).any() else x
        for x in leaves]
    jp = jax.tree.unflatten(tree, leaves)
    return jcfg, jp, cfg, from_jax_params(jax.tree.map(np.asarray, jp), cfg,
                                          "cpu")


def _jobs(vocab, sizes=((8, 7), (8, 9), (12, 6), (12, 8))):
    rng = np.random.RandomState(0)
    return [(rng.randint(0, vocab, n).astype(np.int32), new)
            for n, new in sizes]


def _serve(engine, jobs):
    for i, (p, n) in enumerate(jobs):
        engine.submit(i, p, n)
    return {r.rid: list(r.generated) for r in engine.run_to_completion()}


ENGINE_KW = dict(num_blocks=64, block_size=8, max_seqs=4)


@functools.lru_cache(maxsize=None)
def _jax_tokens(arch, **over):
    jcfg, jp, cfg, _ = _model(arch, **over)
    return _serve(JaxEngine(jcfg, jp, **ENGINE_KW), _jobs(cfg.vocab_size))


def _sharded(arch, tp, pp, over=(), **kw):
    jcfg, jp, cfg, params = _model(arch, **dict(over))
    plan, run_cfg = make_plan(cfg, "serve", False, 1, tp=tp, pp=pp)
    if run_cfg is not cfg:
        params = pad_attention_params(params, cfg, run_cfg)
    mesh = make_replica_mesh(DEVICES[:tp * pp], tp, pp)
    eng = ServingEngine(run_cfg, params, mesh=mesh, shard_plan=plan,
                        device="cpu", **ENGINE_KW, **kw)
    return eng, plan, _serve(eng, _jobs(cfg.vocab_size))


@functools.lru_cache(maxsize=None)
def _unsharded(arch):
    _, _, cfg, params = _model(arch)
    eng = ServingEngine(cfg, params, device="cpu", **ENGINE_KW)
    return eng, _serve(eng, _jobs(cfg.vocab_size))


@pytest.mark.parametrize("tp,pp", [(1, 1), (2, 1), (1, 2), (2, 2)])
def test_sharded_tokens_equal_jax_and_unsharded(tp, pp):
    want = _jax_tokens("yi-9b")
    ref_eng, ref = _unsharded("yi-9b")
    assert ref == want
    eng, plan, got = _sharded("yi-9b", tp, pp)
    assert got == want, (tp, pp)
    cfg = eng.cfg
    # the pool and the weights are really split, not replicated
    assert pool_pspecs(cfg, plan) is not None
    for pi, mi, k in eng.cache.k:
        assert k.shape[0] == cfg.n_layers // pp          # layers over pipe
        assert k.shape[2] == cfg.n_kv_heads // tp        # KV heads / model
        wq = eng.params.shards[pi][mi]["blocks"]["attn"]["wq"]
        assert wq.shape[-1] == cfg.q_dim // tp
        assert wq.shape[0] == cfg.n_layers // pp
    if (tp, pp) == (1, 1):
        # one shard: the unsharded engine's operations, to the bit
        for name in ("k", "v"):
            assert torch.equal(getattr(eng.cache, name).parts[0][0],
                               getattr(ref_eng.cache, name))
        assert eng.prefill_tokens == ref_eng.prefill_tokens
        assert eng.decode_syncs == ref_eng.decode_syncs


@pytest.mark.parametrize("kw", [dict(decode_horizon=4),
                                dict(prefill_chunk_tokens=4)])
def test_sharded_horizon_and_chunks_keep_parity(kw):
    want = _jax_tokens("yi-9b")
    eng, _, got = _sharded("yi-9b", 2, 1, **kw)
    assert got == want
    if "decode_horizon" in kw:
        assert max(eng.horizon_counts) == 4
    else:
        # the 12-token prompts went through three chunks
        assert eng.prefill_tokens == sum(len(p) for p, _ in
                                         _jobs(eng.cfg.vocab_size))


def test_padded_mha_replica_matches_unpadded_jax():
    """attn "pad" mode: 2 MHA heads padded to 4 at tp 4 (the padding is
    function-preserving), one head and one KV head a shard."""
    over = (("n_q_heads", 2), ("n_kv_heads", 2), ("head_dim", 32),
            ("attn_sharding", "pad"))
    want = _jax_tokens("yi-9b", **dict(over))
    eng, plan, got = _sharded("yi-9b", 4, 1, over)
    assert plan.attn_mode == "pad" and eng.cfg.n_q_heads == 4
    assert [k.shape[2] for _, _, k in eng.cache.k] == [1, 1, 1, 1]
    assert got == want


def test_replicated_kv_heads_read_their_group():
    """tp 4 over yi-9b smoke's 4 query / 2 KV heads: the KV heads do not
    divide tp, so the spec replicates them and each shard keeps the one KV
    head its query head reads (shards 0, 1 read head 0; 2, 3 head 1)."""
    want = _jax_tokens("yi-9b")
    eng, plan, got = _sharded("yi-9b", 4, 1)
    assert plan.rules["kv_heads"] is None
    assert tuple(pool_pspecs(eng.cfg, plan)) == (None,) * 5
    assert eng.params.heads == [(0, 1, 0, 1), (1, 2, 0, 1), (2, 3, 1, 2),
                                (3, 4, 1, 2)]
    assert [k.shape[2] for _, _, k in eng.cache.k] == [1, 1, 1, 1]
    assert got == want


def test_replicate_mode_keeps_attention_on_the_first_shard():
    over = (("n_q_heads", 2), ("n_kv_heads", 2), ("head_dim", 32),
            ("attn_sharding", "replicate"))
    want = _jax_tokens("yi-9b", **dict(over))
    eng, plan, got = _sharded("yi-9b", 2, 1, over)
    assert plan.attn_mode == "replicate"
    assert [k.shape[2] for _, _, k in eng.cache.k] == [2, 0]
    assert got == want


@pytest.mark.parametrize("arch,tp,pp", [
    ("opt-30b", 2, 2),          # gelu MLP with b_up/b_down, sincos, untied
    ("starcoder2-3b", 2, 1),    # q/k/v and MLP biases
    ("gemma2-2b", 2, 1),        # sandwich norms, softcaps, local window
])
def test_dense_families_sharded_equal_jax(arch, tp, pp):
    want = _jax_tokens(arch)
    _, _, got = _sharded(arch, tp, pp)
    assert got == want


@pytest.mark.parametrize("arch,tp,pp", [("olmoe-1b-7b", 2, 1),
                                        ("hymba-1.5b", 1, 2),
                                        ("mamba2-370m", 2, 1)])
def test_moe_and_ssm_sharded_equal_unsharded(arch, tp, pp):
    """MoE and SSM/hybrid replicas serve the port's unsharded engine's
    tokens (``test_torch_sharded_moe_ssm.py`` holds both against JAX)."""
    _, ref = _unsharded(arch)
    _, _, got = _sharded(arch, tp, pp)
    assert got == ref


def test_sharded_engine_checks():
    _, _, cfg, params = _model("yi-9b")
    plan, _ = make_plan(cfg, "serve", False, 1, tp=2)
    mesh = make_replica_mesh(DEVICES[:2], 2)
    with pytest.raises(ValueError, match="needs shard_plan"):
        ServingEngine(cfg, params, mesh=mesh, device="cpu", **ENGINE_KW)
    with pytest.raises(ValueError, match="decode_mode='paged'"):
        ServingEngine(cfg, params, mesh=mesh, shard_plan=plan,
                      decode_mode="dense", device="cpu", **ENGINE_KW)
    eng = ServingEngine(cfg, params, mesh=mesh, shard_plan=plan,
                        device="cpu", **ENGINE_KW)
    with pytest.raises(ValueError, match="different mesh"):
        ServingEngine(cfg, params, pool=eng.cache.pool, device="cpu",
                      **ENGINE_KW)


@pytest.mark.parametrize("arch,tp,pp", [("yi-9b", 2, 2), ("opt-30b", 4, 1),
                                        ("gemma2-2b", 2, 2)])
def test_sharded_forward_equals_unsharded(arch, tp, pp):
    """``sharded.forward`` (the full-sequence logits) against the
    unsharded ``forward`` on the same weights, fp32: the shards' sums
    round otherwise, so within 1e-5 of the logits' largest value."""
    _, _, cfg, params = _model(arch)
    plan, run_cfg = make_plan(cfg, "serve", False, 1, tp=tp, pp=pp)
    if run_cfg is not cfg:
        params = pad_attention_params(params, cfg, run_cfg)
    sm = sharded.ShardedModel.build(params, run_cfg, plan,
                                    make_replica_mesh(DEVICES[:tp * pp],
                                                      tp, pp))
    tokens = torch.from_numpy(np.random.RandomState(4).randint(
        0, cfg.vocab_size, (2, 24)).astype(np.int64))
    want = forward(params, run_cfg, tokens)
    got = sharded.forward(sm, run_cfg, tokens)
    assert got.shape == want.shape
    rel = float((got - want).abs().max() / want.abs().max())
    assert rel < 1e-5, rel
