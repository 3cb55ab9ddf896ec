"""The port's chunked prefill against the JAX package's, on the CPU.

Three layers: the prefill kernel's plain version with a query offset
(``ref.flash_attention_ref(q_offset=...)``) against the attention of JAX's
``prefill_chunk_attention``; ``prefill_chunk`` against JAX's on the same
pools; and the engine with ``prefill_chunk_tokens`` against the JAX engine,
step by step, on the chunked-prefill cases of the JAX package's own tests
(``tests/test_horizon_decode.py``: the horizon collapses while a chunk is
in flight; the chunk budget is shared round-robin).  fp32: the
kernel-level comparisons hold to ATOL_KERNEL = 3e-5, the model-level ones
to ATOL = 1e-4; tokens, counters and per-step schedules are equal.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_engine import (_counters, _device_state_close,
                               _quickstart_job, _weights)
from test_torch_kernels_gpu import (CHUNK_CASES, CHUNK_IDS, close,
                                    flash_inputs, to_torch)

import repro.models as jm
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro.serving.engine import ServingEngine as JaxEngine
from repro_torch import models as tm
from repro_torch.kernels import ops, ref
from repro_torch.serving.engine import ServingEngine

ATOL_KERNEL = 3e-5
ATOL = 1e-4
PAGE = 8


# --------------------------------------------------------------------------
# The prefill kernel's plain version with a query offset (B2).
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name,B,C,off,Hq,Hkv,D,cap,win", CHUNK_CASES,
                         ids=CHUNK_IDS)
def test_flash_attention_q_offset_matches_jax(name, B, C, off, Hq, Hkv, D,
                                              cap, win):
    """C queries at positions off + [0, C) over the off + C keys: JAX's
    chunk attention (``_attend`` on GQA-expanded K/V, as
    ``prefill_chunk_attention`` calls it) and the last C rows of its
    whole-sequence oracle."""
    q, k, v = flash_inputs(26, B, C, off + C, Hq, Hkv, D)
    got = ref.flash_attention_ref(*to_torch(q, k, v), softcap=cap,
                                  window=win, q_offset=off).numpy()
    jcfg = dataclasses.replace(_weights("gemma2-2b")[0], n_q_heads=Hq,
                               n_kv_heads=Hkv, head_dim=D,
                               attn_logit_softcap=cap, local_window=win)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want = jattn._attend(jq, jattn._expand_kv(jk, Hq),
                         jattn._expand_kv(jv, Hq), jcfg,
                         off + jnp.arange(C), jnp.arange(off + C),
                         is_local=win > 0)
    close(got, want, ATOL_KERNEL)
    r = np.random.RandomState(27)
    q_all = np.concatenate(
        [(r.randn(B, off, Hq, D) * 0.5).astype(np.float32), q], axis=1)
    whole = jref.flash_attention_ref(jnp.asarray(q_all), jk, jv, softcap=cap,
                                     window=win)
    close(got, np.asarray(whole)[:, off:], ATOL_KERNEL)


def test_ops_flash_attention_q_offset_on_cpu_is_the_plain_version():
    q, k, v = to_torch(*flash_inputs(28, 1, 16, 56, 4, 2, 32))
    before = ops.launch_counts()
    got = ops.flash_attention(q, k, v, window=20, q_offset=40)
    assert torch.equal(got, ref.flash_attention_ref(q, k, v, window=20,
                                                    q_offset=40))
    assert ops.launch_counts() == before


# --------------------------------------------------------------------------
# prefill_chunk on the paged pool.
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["yi-9b", "gemma2-2b"])
def test_prefill_chunk_matches_jax(arch):
    """A 90-token prompt in chunks of 32, 32 and 26 (the last bucketed to
    32, its tail on the trash page), crossing gemma2-smoke's 64-token
    local window: each chunk's logits and the pools within ATOL."""
    jcfg, jp, cfg, tp = _weights(arch)
    r = np.random.RandomState(29)
    S, C = 90, 32
    toks = r.randint(0, cfg.vocab_size, (1, S)).astype(np.int32)
    n = (S + PAGE - 1) // PAGE
    P = n + 4
    table = r.permutation(P)[:n][None].astype(np.int32)
    shape = (cfg.n_layers, P + 1, cfg.n_kv_heads, PAGE, cfg.head_dim)
    jk = jv = jnp.zeros(shape, jnp.float32)
    tk = torch.zeros(shape)
    tv = torch.zeros(shape)
    for start in range(0, S, C):
        n_valid = min(C, S - start)
        buf = np.zeros((1, C), np.int32)
        buf[0, :n_valid] = toks[0, start:start + n_valid]
        jlogits, jk, jv = jm.prefill_chunk(
            jp, jcfg, jnp.asarray(buf), jk, jv, jnp.asarray(table),
            jnp.int32(start), jnp.int32(n_valid), P)
        logits = tm.prefill_chunk(tp, cfg, torch.from_numpy(buf), tk, tv,
                                  torch.from_numpy(table), start, n_valid, P)
        close(logits.numpy(), jlogits, ATOL)
    # every real page agrees; the trash page (last) takes the bucketed
    # tail in whichever order the scatter applies it
    close(tk[:, :P].numpy(), np.asarray(jk)[:, :P], ATOL)
    close(tv[:, :P].numpy(), np.asarray(jv)[:, :P], ATOL)


def test_chunk_and_dense_decode_hand_the_kernels_contiguous_inputs(
        monkeypatch):
    """The CUDA kernels take raw pointers and refuse strided tensors; the
    plain versions do not care, so the CPU run checks the kernels' input
    contract at the ops boundary.  A one-page table is the case where the
    page gather is a strided view."""
    seen = []

    def contiguous_only(fn):
        def check(*args, **kw):
            tensors = [a for a in args if isinstance(a, torch.Tensor)]
            seen.append(all(t.is_contiguous() for t in tensors))
            return fn(*args, **kw)
        return check

    for name in ("flash_attention", "flash_decode"):
        monkeypatch.setattr(ops, name, contiguous_only(getattr(ops, name)))
    _, _, cfg, tp = _weights("gemma2-2b")
    shape = (cfg.n_layers, 3, cfg.n_kv_heads, PAGE, cfg.head_dim)
    k, v = torch.zeros(shape), torch.zeros(shape)
    toks = torch.arange(8, dtype=torch.int32)[None]
    tm.prefill_chunk(tp, cfg, toks, k, v,
                     torch.tensor([[1]], dtype=torch.int32), 0, 6, 2)
    cache = tm.DecodeCache(
        k=torch.zeros(cfg.n_layers, 2, 9, cfg.n_kv_heads, cfg.head_dim),
        v=torch.zeros(cfg.n_layers, 2, 9, cfg.n_kv_heads, cfg.head_dim),
        ssm=None, conv=None, pos=torch.tensor([3, 8], dtype=torch.int32))
    tm.decode_step(tp, cfg, torch.tensor([1, 2], dtype=torch.int32), cache)
    assert len(seen) == 2 * cfg.n_layers and all(seen)


def test_prefill_chunk_refuses_ssm():
    _, _, cfg, tp = _weights("hymba-1.5b")
    with pytest.raises(NotImplementedError, match="attention-only"):
        tm.prefill_chunk(tp, cfg, torch.zeros((1, 8), dtype=torch.int32),
                         None, None, None, 0, 8, 0)


# --------------------------------------------------------------------------
# The chunked engine.
# --------------------------------------------------------------------------

def _snapshot(e):
    """What a step decided: counters, the horizon and every active
    request's prefill position and tokens."""
    active = sorted((r.rid, r.prefill_pos, list(r.generated))
                    for r in e.active.values())
    return _counters(e) + (e.last_horizon, active)


@pytest.mark.parametrize("arch,horizon", [
    ("yi-9b", 1), ("yi-9b", 8), ("gemma2-2b", 8), ("hymba-1.5b", 8)])
def test_chunked_engine_matches_jax(arch, horizon):
    """The quickstart job with 8-token chunks: most prompts stream in over
    several steps, several at once, sharing the budget.  (hymba has SSM
    layers: both engines ignore the chunk size and prefill one-shot.)"""
    jcfg, jp, cfg, tp = _weights(arch)
    kw = dict(num_blocks=128, block_size=8, max_seqs=4,
              decode_horizon=horizon, prefill_chunk_tokens=8)
    jeng = JaxEngine(jcfg, jp, **kw)
    want = _quickstart_job(jeng, jcfg.vocab_size)
    eng = ServingEngine(cfg, tp, device="cpu", **kw)
    assert eng.prefill_chunk_tokens == (None if cfg.has_ssm else 8)
    got = _quickstart_job(eng, cfg.vocab_size)
    assert got == want
    assert _counters(eng) == _counters(jeng)
    assert eng.horizon_counts == jeng.horizon_counts
    assert eng.last_horizon == jeng.last_horizon
    _device_state_close(eng, jeng)


def _horizon_collapse_run(e, vocab):
    """``test_horizon_collapses_during_chunked_prefill``'s schedule: a
    32-token prompt streams in 8-token chunks while an earlier request
    decodes at horizon 8.  Returns (per-step snapshots, tokens)."""
    rng = np.random.RandomState(4)
    snaps, done = [], []
    e.submit(0, rng.randint(0, vocab, 8).astype(np.int32), 24)
    done += e.step()
    snaps.append(_snapshot(e))
    e.submit(1, rng.randint(0, vocab, 32).astype(np.int32), 4)
    while e.waiting or e.active:
        done += e.step()
        snaps.append(_snapshot(e))
    return snaps, {r.rid: r.generated for r in done}


def _round_robin_run(e, vocab):
    """``test_chunked_prefill_round_robin_no_hol``'s schedule: two
    64-token prompts admitted together share a 16-token budget."""
    rng = np.random.RandomState(5)
    p0 = rng.randint(0, vocab, 64).astype(np.int32)
    p1 = rng.randint(0, vocab, 64).astype(np.int32)
    e.submit(0, p0, 3)
    e.submit(1, p1, 3)
    snaps, done = [], []
    while e.waiting or e.active:
        done += e.step()
        snaps.append(_snapshot(e))
    return snaps, {r.rid: r.generated for r in done}


@pytest.mark.parametrize("run,kw", [
    (_horizon_collapse_run, dict(decode_horizon=8, prefill_chunk_tokens=8)),
    (_round_robin_run, dict(prefill_chunk_tokens=16)),
], ids=["horizon-collapse", "round-robin"])
def test_chunk_schedule_matches_jax(run, kw):
    """Step for step the same chunk positions, horizons, tokens and
    counters as the JAX engine; and the JAX tests' own properties hold."""
    jcfg, jp, cfg, tp = _weights("yi-9b")
    kw = dict(num_blocks=128, block_size=8, max_seqs=2, **kw)
    want, want_toks = run(JaxEngine(jcfg, jp, **kw), jcfg.vocab_size)
    got, got_toks = run(ServingEngine(cfg, tp, device="cpu", **kw),
                        cfg.vocab_size)
    assert got == want
    assert got_toks == want_toks
    positions = [{rid: pos for rid, pos, _ in snap[-1]} for snap in got]
    if run is _horizon_collapse_run:
        # one token per step while rid 1 waits or streams in (its state
        # before the step), then the horizon reopens
        busy = [i == 1 or positions[i - 1].get(1, 32) < 32
                for i in range(1, len(got))]
        first_free = busy.index(False) + 1
        assert first_free > 2
        assert all(got[i][4] == 1 for i in range(1, first_free))
        assert got[first_free][4] > 1
    else:
        # after one step both prompts advanced; they never drift apart by
        # more than one budget
        assert all(0 < p < 64 for p in positions[0].values())
        for pos in positions:
            if len(pos) == 2:
                assert abs(pos[0] - pos[1]) <= 16
