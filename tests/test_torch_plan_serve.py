"""The JAX package's prefill and decode plans executed by the port on the
CPU, fp32, against JAX's unsharded ``prefill`` and ``decode_step``.

The prefill plan (batch over data, heads over model) gives the last
position's logits within REL = 1e-4 of their largest value and the
``DecodeCache`` in ``cache_pspecs``'s layout, which ``gather_cache``
turns back into JAX's cache within ATOL = 1e-4.  ``reshard_cache`` moves
it to the decode plan's layout (the sequence over model, or at batch 1
over (data, model); KV heads whole), and 8 greedy steps of
``decode_step_plan`` (B3 with its log-sum-exp on each sequence shard, the
partials combined) give JAX's tokens and logits within REL.  Cases cover
batch 4 and batch 1, shards whose range lies past the position or before
gemma2's local window (empty: zeros and an lse of -inf), gemma2's
softcap, mamba2's and hymba's SSM rows, and the mesh of ones, bit-equal to
the port's unsharded prefill and dense decode.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_plan_forward import (one_thread, plan_model, rel_err,  # noqa: F401
                                     tokens_for, weights)

import repro.models as jm
from repro.models.model import init_cache as jax_init_cache
from repro_torch.kernels import ref
from repro_torch.launch import sharding as shd
from repro_torch.models import model as tmodel
from repro_torch.models import sharded

REL = ATOL = 1e-4
STEPS = 8


def jax_stream(arch: str, B: int, S: int):
    """JAX's prefill logits and cache, then STEPS greedy decode steps at a
    cache of S + STEPS positions: (logits list, tokens list, prefill
    cache)."""
    jcfg, jparams, cfg, _ = weights(arch)
    tokens = jnp.asarray(tokens_for(cfg, B, S))
    logits, pc = jax.jit(lambda p, t: jm.prefill(p, jcfg, t))(jparams,
                                                               tokens)
    cache = jax_init_cache(jcfg, B, S + STEPS, jnp.float32)
    if pc.k is not None:
        cache = dataclasses.replace(cache,
                                    k=cache.k.at[:, :, :S].set(pc.k),
                                    v=cache.v.at[:, :, :S].set(pc.v))
    cache = dataclasses.replace(cache, ssm=pc.ssm, conv=pc.conv, pos=pc.pos)
    step = jax.jit(lambda p, t, c: jm.decode_step(p, jcfg, t, c))
    outs, toks = [np.asarray(logits)], [np.asarray(logits).argmax(-1)]
    for _ in range(STEPS):
        logits, cache = step(jparams, jnp.asarray(toks[-1], jnp.int32),
                             cache)
        outs.append(np.asarray(logits))
        toks.append(outs[-1].argmax(-1))
    return outs, toks, pc


def plan_stream(arch: str, B: int, S: int, dp: int, tp: int):
    """The port's prefill plan, ``reshard_cache`` and STEPS greedy steps
    of the decode plan: (logits list, tokens list, the prefill cache
    gathered, the decode plan)."""
    _, _, cfg, params = weights(arch)
    pm, pplan, mesh = plan_model(params, cfg, "prefill", B, dp, tp)
    tokens = torch.from_numpy(tokens_for(cfg, B, S))
    logits, cache = sharded.prefill_plan(
        pm, [p["t"] for p in shd.shard_batch({"t": tokens}, pplan, mesh)])
    logits = torch.cat(logits)
    gathered = shd.gather_cache(cache, pm.cfg, pplan, mesh)
    dm, dplan, _ = plan_model(params, cfg, "decode", B, dp, tp)
    cache = shd.reshard_cache(cache, pm.cfg, pplan, dplan, mesh,
                              max_len=S + STEPS)
    outs, toks = [logits], [logits.argmax(-1).to(torch.int32)]
    for _ in range(STEPS):
        parts = shd.shard_batch({"t": toks[-1]}, dplan, mesh)
        logits, cache = sharded.decode_step_plan(
            dm, [p["t"] for p in parts], cache)
        outs.append(torch.cat(logits))
        toks.append(outs[-1].argmax(-1).to(torch.int32))
    return outs, toks, gathered, dplan


# arch, batch, prompt length, (data, model)
CASES = [
    ("yi-9b", 4, 32, 2, 2), ("yi-9b", 4, 32, 4, 2), ("yi-9b", 1, 32, 4, 2),
    ("gemma2-2b", 4, 80, 2, 2), ("gemma2-2b", 1, 80, 4, 2),
    ("mamba2-370m", 4, 32, 2, 2), ("mamba2-370m", 1, 32, 4, 2),
    ("hymba-1.5b", 2, 32, 2, 2), ("olmoe-1b-7b", 4, 24, 2, 2),
]


@pytest.mark.parametrize("arch,B,S,dp,tp", CASES,
                         ids=[f"{a}-b{b}-d{d}m{t}" for a, b, _, d, t in CASES])
def test_prefill_and_decode_plans_match_jax(arch, B, S, dp, tp):
    want, want_toks, pc = jax_stream(arch, B, S)
    got, got_toks, cache, dplan = plan_stream(arch, B, S, dp, tp)
    assert dplan.rules["kv_seq"] == ("model" if B > 1 else ("data", "model"))
    assert dplan.rules["kv_heads"] is None
    for name in ("k", "v", "ssm", "conv"):
        w = getattr(pc, name)
        if w is None:
            assert getattr(cache, name) is None
            continue
        np.testing.assert_allclose(getattr(cache, name).numpy(),
                                   np.asarray(w), atol=ATOL, rtol=0)
    assert cache.pos.tolist() == [S] * B
    for i, (g, w) in enumerate(zip(got, want)):
        assert rel_err(g.numpy(), w) <= REL, i
    assert [t.tolist() for t in got_toks] == [t.tolist() for t in want_toks]


def test_sequence_shards_past_the_position_or_window_are_empty():
    """At batch 1 on (data 4, model 2) the decode cache of 88 positions is
    split into 8 ranges of 11; at the first step (position 80) the last
    range [77, 88) holds the position, none lies wholly past it at this
    size, and gemma2's local window of 64 leaves [0, 11) empty: its
    shifted, clipped lens/start select nothing, and B3's plain version
    gives zeros and an lse of -inf there."""
    _, _, cfg, params = weights("gemma2-2b")
    dm, dplan, mesh = plan_model(params, cfg, "decode", 1, 4, 2)
    S = 80 + STEPS
    logical = tmodel.DecodeCache(
        torch.randn(cfg.n_layers, 1, S, cfg.n_kv_heads, cfg.head_dim),
        torch.randn(cfg.n_layers, 1, S, cfg.n_kv_heads, cfg.head_dim),
        None, None, torch.tensor([80], dtype=torch.int32))
    cache = shd.shard_cache(logical, dm.cfg, dplan, mesh)
    shards = sharded.seq_shards(dm, cache, 0)
    assert [s[2:] for s in shards] == [(i * 11, i * 11 + 11)
                                       for i in range(8)]
    assert [(r, m) for r, m, *_ in shards] == [(r, m) for r in range(4)
                                               for m in range(2)]
    pos = torch.tensor([80], dtype=torch.int32)
    lens, start = tmodel.attn_lib._decode_window(pos, cfg, True)
    assert int(start) == 17
    q = torch.randn(1, cfg.n_q_heads, cfg.head_dim)
    k, v = cache.k.parts[0][0][0], cache.v.parts[0][0][0]
    out, lse = ref.flash_decode_plain(
        q, k, v, torch.clamp(lens - 0, 0, 11), torch.clamp(start - 0, 0, 11),
        50.0, cfg.head_dim ** -0.5, with_lse=True)
    assert not out.any() and bool((lse == -torch.inf).all())


@pytest.mark.parametrize("arch", ["yi-9b", "gemma2-2b", "mamba2-370m",
                                  "hymba-1.5b"])
def test_mesh_of_ones_is_bit_equal_to_unsharded(arch):
    """Every axis of size 1: the prefill plan's logits and cache equal the
    unsharded ``prefill``'s, and the decode plan's steps the unsharded
    dense ``decode_step``'s, bit for bit."""
    B, S = 2, 40
    _, _, cfg, params = weights(arch)
    got, got_toks, cache, _ = plan_stream(arch, B, S, 1, 1)
    tokens = torch.from_numpy(tokens_for(cfg, B, S))
    logits, pc = tmodel.prefill(params, cfg, tokens)
    assert torch.equal(got[0], logits)
    for name in ("k", "v", "ssm", "conv"):
        w = getattr(pc, name)
        assert (w is None) == (getattr(cache, name) is None)
        if w is not None:
            assert torch.equal(getattr(cache, name), w)
    k = v = None
    if pc.k is not None:
        k = torch.zeros(cfg.n_layers, B, S + STEPS, *pc.k.shape[3:])
        v = torch.zeros_like(k)
        k[:, :, :S], v[:, :, :S] = pc.k, pc.v
    dc = tmodel.DecodeCache(k, v, pc.ssm, pc.conv,
                            torch.full((B,), S, dtype=torch.int32))
    tok = got_toks[0]
    for i in range(STEPS):
        logits, dc = tmodel.decode_step(params, cfg, tok, dc)
        assert torch.equal(got[i + 1], logits), i
        tok = logits.argmax(-1).to(torch.int32)
        assert torch.equal(tok, got_toks[i + 1])


def test_plain_lse_matches_float64():
    """B3's plain version with ``with_lse``: the log-sum-exp of each
    row's attended scaled, softcapped scores, against float64, on rows
    with a window, a softcap and an empty range (len <= start: zeros and
    -inf); the output is the same with and without it."""
    g = torch.Generator().manual_seed(3)
    B, S, Hq, Hkv, D = 4, 70, 8, 2, 32
    q = torch.randn(B, Hq, D, generator=g)
    k = torch.randn(B, S, Hkv, D, generator=g)
    v = torch.randn(B, S, Hkv, D, generator=g)
    lens = torch.tensor([70, 33, 10, 0], dtype=torch.int32)
    start = torch.tensor([0, 20, 10, 0], dtype=torch.int32)
    for softcap in (0.0, 5.0):
        out, lse = ref.flash_decode_plain(q, k, v, lens, start, softcap,
                                          D ** -0.5, with_lse=True)
        assert torch.equal(out, ref.flash_decode_plain(
            q, k, v, lens, start, softcap, D ** -0.5))
        kk = k.double().repeat_interleave(Hq // Hkv, dim=2)
        s = torch.einsum("bhd,bkhd->bhk", q.double(), kk) * D ** -0.5
        if softcap:
            s = softcap * torch.tanh(s / softcap)
        for b in range(B):
            lo, hi = int(start[b]), int(lens[b])
            if hi <= lo:
                assert not out[b].any()
                assert bool((lse[b] == -torch.inf).all())
                continue
            want = torch.logsumexp(s[b, :, lo:hi], dim=-1)
            np.testing.assert_allclose(lse[b].numpy(), want.numpy(),
                                       atol=1e-5, rtol=0)
