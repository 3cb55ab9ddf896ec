"""The port's ``ServingEngine`` against the JAX package's, on the same
weights and the same job (the quickstart job: 6 requests, prompts of 8-24
tokens, 12 new tokens, ``RandomState(0)``).  fp32 on the CPU: greedy
streams, counters and the final K/V pools and SSM rows must agree; those
within ATOL = 1e-4 (the same fp32 math in another order).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as jm
from repro.configs import get_smoke_config as jax_smoke_config
from repro.serving import kvcache as jkv
from repro.serving.engine import LOAD_STATS_KEYS
from repro.serving.engine import ServingEngine as JaxEngine
from repro_torch.configs import get_smoke_config
from repro_torch.convert import from_jax_params
from repro_torch.serving import kvcache as tkv
from repro_torch.serving.engine import ServingEngine

ATOL = 1e-4
ENGINE_KW = dict(num_blocks=128, block_size=8, max_seqs=4)


@functools.lru_cache(maxsize=None)
def _weights(arch):
    jcfg = jax_smoke_config(arch)
    cfg = get_smoke_config(arch)
    jp = jm.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return jcfg, jp, cfg, tp


def _quickstart_job(engine, vocab):
    rng = np.random.RandomState(0)
    for rid in range(6):
        prompt = rng.randint(0, vocab, rng.randint(8, 24))
        engine.submit(rid, prompt.astype(np.int32), 12)
    return {r.rid: list(r.generated) for r in engine.run_to_completion()}


def _counters(e):
    return (e.decode_syncs, e.steps, e.tokens_out, e.prefill_tokens)


def _device_state_close(eng, jeng):
    """Pools, and the real slots' SSM rows (the trash row takes the padded
    rows' updates in whichever order the scatter applies them), agree."""
    n = eng.max_seqs
    for name, rows in (("k", None), ("v", None), ("ssm", n), ("conv", n)):
        got, want = getattr(eng.cache, name), getattr(jeng.cache, name)
        assert (got is None) == (want is None), name
        if got is not None:
            np.testing.assert_allclose(
                got[:, :rows].numpy(), np.asarray(want)[:, :rows],
                atol=ATOL, rtol=0)


@pytest.mark.parametrize("arch,horizon", [
    ("yi-9b", 1), ("yi-9b", 8), ("gemma2-2b", 8), ("mamba2-370m", 1),
    ("mamba2-370m", 8), ("hymba-1.5b", 1), ("hymba-1.5b", 8)])
def test_engine_matches_jax(arch, horizon):
    jcfg, jp, cfg, tp = _weights(arch)
    jeng = JaxEngine(jcfg, jp, decode_horizon=horizon, **ENGINE_KW)
    want = _quickstart_job(jeng, jcfg.vocab_size)
    eng = ServingEngine(cfg, tp, decode_horizon=horizon, device="cpu",
                        **ENGINE_KW)
    got = _quickstart_job(eng, cfg.vocab_size)
    assert got == want
    assert all(len(t) == 12 for t in got.values())
    assert _counters(eng) == _counters(jeng)
    if horizon > 1:
        # each request decodes 11 tokens after its first: one sync per step
        # would take at least 11
        assert eng.decode_syncs < 11
    # every K/V token landed in the same page and row, and every slot
    # holds the same SSM state
    _device_state_close(eng, jeng)


SCHEDULES = [
    # name, arch, (prompt len, new tokens) per request, horizon, max_seqs,
    # blocks, prompt seed
    ("staggered-retire", "yi-9b", ((8, 9), (8, 17), (12, 5)), 8, 2, 64, 1),
    ("retire-boundary", "yi-9b", ((8, 4), (8, 20)), 16, 2, 64, 1),
    ("pool-bound-admission", "yi-9b", ((20, 12), (20, 12), (8, 4)), 4, 4, 8,
     1),
    # the mamba2 jobs of the JAX package's horizon-parity test
    ("ssm-horizon-1", "mamba2-370m", ((8, 6), (8, 11)), 1, 2, 64, 2),
    ("ssm-horizon-8", "mamba2-370m", ((8, 6), (8, 11)), 8, 2, 64, 2),
]


@pytest.mark.parametrize("name,arch,jobs,horizon,max_seqs,blocks,seed",
                         SCHEDULES, ids=[s[0] for s in SCHEDULES])
def test_engine_schedule_matches_jax(name, arch, jobs, horizon, max_seqs,
                                     blocks, seed):
    """Admission waiting on slots or on reserved blocks, retirement inside
    a horizon's budget and the power-of-two horizon floor make the same
    decisions, step for step, as in the JAX engine."""
    jcfg, jp, cfg, tp = _weights(arch)
    rng = np.random.RandomState(seed)
    prompts = [(rng.randint(0, cfg.vocab_size, n).astype(np.int32), new)
               for n, new in jobs]
    kw = dict(num_blocks=blocks, block_size=8, max_seqs=max_seqs,
              decode_horizon=horizon)
    engines = (JaxEngine(jcfg, jp, **kw),
               ServingEngine(cfg, tp, device="cpu", **kw))
    streams = []
    for e in engines:
        for rid, (p, new) in enumerate(prompts):
            e.submit(rid, p, new)
        streams.append({r.rid: r.generated
                        for r in e.run_to_completion()})
    assert streams[1] == streams[0]
    assert _counters(engines[1]) == _counters(engines[0])
    assert engines[1].horizon_counts == engines[0].horizon_counts
    assert engines[1].cache.n_free_blocks == blocks


def test_load_stats_keys_match_jax():
    _, _, cfg, tp = _weights("yi-9b")
    eng = ServingEngine(cfg, tp, device="cpu", **ENGINE_KW)
    eng.submit(0, np.arange(10, dtype=np.int32), 3)
    eng.step()
    stats = eng.load_stats()
    assert set(stats) == set(LOAD_STATS_KEYS)
    # the first token comes from prefill; decoding starts on the next step
    assert stats["active"] == 1 and stats["tokens_out"] == 1


def test_engine_refuses_what_it_can_never_serve():
    _, _, cfg, tp = _weights("yi-9b")
    eng = ServingEngine(cfg, tp, device="cpu", max_blocks_per_seq=4,
                        **ENGINE_KW)
    with pytest.raises(ValueError, match="block capacity"):
        eng.submit(0, np.zeros(30, np.int32), 4)
    with pytest.raises(ValueError, match="max_new_tokens"):
        eng.submit(1, np.zeros(3, np.int32), 0)


def test_kvcache_bookkeeping_matches_jax():
    """The same admit / extend / release sequence leaves the same block
    ids, tables, lengths and device mirrors in both packages."""
    jcfg, _, cfg, _ = _weights("yi-9b")
    kw = dict(num_blocks=24, block_size=4, max_seqs=3, max_blocks_per_seq=8)
    j = jkv.PagedKVCache.create(jcfg, dtype=jnp.float32, **kw)
    t = tkv.PagedKVCache.create(cfg, dtype=torch.float32, device="cpu", **kw)
    r = np.random.RandomState(0)
    k_seq = r.randn(cfg.n_layers, 9, cfg.n_kv_heads, cfg.head_dim)
    v_seq = r.randn(*k_seq.shape)

    def ext(c, slot, n):
        # the port's extend_for always defers its device update; JAX's
        # does so with sync_device=False
        if c is j:
            return c.extend_for(slot, n, sync_device=False)
        return c.extend_for(slot, n)

    for c, put in ((j, jnp.asarray), (t, torch.from_numpy)):
        assert c.can_admit(9, total_tokens=20)
        c.admit(0, 9, total_tokens=20)
        c.admit(1, 3, total_tokens=6)
        c.write_prefill(0, put(k_seq.astype(np.float32)),
                        put(v_seq.astype(np.float32)))
        c.apply_table_updates([ext(c, 0, 4), ext(c, 1, 2)])
        assert ext(c, 1, 1) is None      # still inside slot 1's last page
        c.release_slot(1)
        c.admit(2, 5, total_tokens=9)
        assert not c.can_admit(40, total_tokens=80)
    assert j.seq_blocks == t.seq_blocks
    np.testing.assert_array_equal(j.block_table, t.block_table)
    np.testing.assert_array_equal(j.seq_lens, t.seq_lens)
    np.testing.assert_array_equal(np.asarray(j.block_table_dev),
                                  t.block_table_dev.numpy())
    np.testing.assert_array_equal(np.asarray(j.seq_lens_dev),
                                  t.seq_lens_dev.numpy())
    assert (j.n_free_blocks, j.used_blocks, j.reserved_blocks) == (
        t.n_free_blocks, t.used_blocks, t.reserved_blocks)
    np.testing.assert_array_equal(np.asarray(j.k), t.k.numpy())
    np.testing.assert_array_equal(np.asarray(j.v), t.v.numpy())
