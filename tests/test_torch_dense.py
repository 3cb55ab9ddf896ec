"""The port's dense decode mode against the JAX package's, on the CPU.

Three layers: the plain version of the dense decode kernel
(``ref.flash_decode_plain``) against JAX's oracle and its interpret-mode
Pallas kernel; ``decode_step`` against JAX's on the same prefilled caches;
and the engine with ``decode_mode="dense"`` against the JAX engine in the
same mode.  Inputs and weights are made with numpy / JAX ``init_params``
from a seed and handed to both packages.  fp32: the kernel-level
comparisons hold to ATOL_KERNEL = 3e-5, the model-level ones to
ATOL = 1e-4 (the same fp32 math in another order through a few layers);
greedy tokens and counters are equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_engine import _counters, _device_state_close, _weights
from test_torch_kernels import DECODE_CASES
from test_torch_kernels_gpu import (DENSE_CASES, DENSE_IDS, close,
                                    dense_inputs, to_torch)

import repro.models as jm
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.serving import kvcache as jkv
from repro.serving.engine import ServingEngine as JaxEngine
from repro_torch import models as tm
from repro_torch.kernels import flash_decode as tfd
from repro_torch.kernels import ops, ref
from repro_torch.serving import kvcache as tkv
from repro_torch.serving.engine import ServingEngine

ATOL_KERNEL = 3e-5
ATOL = 1e-4
ARCHS = ["yi-9b", "gemma2-2b", "mamba2-370m", "hymba-1.5b"]


# --------------------------------------------------------------------------
# The dense decode kernel's plain version (B3).
# --------------------------------------------------------------------------

@pytest.mark.parametrize("cap", [0.0, 30.0])
@pytest.mark.parametrize("B,S,Hq,Hkv,D", DECODE_CASES)
def test_flash_decode_plain_matches_jax_kernel(B, S, Hq, Hkv, D, cap):
    """The JAX kernel cases (lens >= 1, no start): the oracle and the
    interpret-mode Pallas kernel through its padding entry."""
    r = np.random.RandomState(180)
    q, k, v, _, start = dense_inputs(18, B, S, Hq, Hkv, D, [S] * B)
    lens = r.randint(1, S + 1, B).astype(np.int32)
    got = ref.flash_decode_plain(*to_torch(q, k, v, lens, start), cap,
                                 1.0 / D ** 0.5).numpy()
    jq, jk, jv, jl = map(jnp.asarray, (q, k, v, lens))
    close(got, jref.flash_decode_ref(jq, jk, jv, jl, softcap=cap),
          ATOL_KERNEL)
    close(got, jops.flash_decode(jq, jk, jv, jl, softcap=cap,
                                 interpret=True), ATOL_KERNEL)


@pytest.mark.parametrize("name,B,S,Hq,Hkv,D,lens,cap,win", DENSE_CASES,
                         ids=DENSE_IDS)
def test_flash_decode_plain_start_matches_jax_oracle(name, B, S, Hq, Hkv, D,
                                                     lens, cap, win):
    """With a local-window ``start`` (which the Pallas kernel lacks; JAX's
    dense path masks it in jnp): held against the oracle."""
    q, k, v, ln, st = dense_inputs(19, B, S, Hq, Hkv, D, lens, window=win)
    got = ref.flash_decode_plain(*to_torch(q, k, v, ln, st), cap,
                                 1.0 / D ** 0.5).numpy()
    want = jref.flash_decode_ref(*map(jnp.asarray, (q, k, v, ln)),
                                 softcap=cap, start=jnp.asarray(st))
    close(got, want, ATOL_KERNEL)


def test_flash_decode_plain_len0_is_zero():
    """At len == 0 the kernel and its plain version write zeros (the JAX
    oracle's all-masked softmax gives the mean of V); the engine never
    attends with len == 0.  The other rows still match the oracle."""
    q, k, v, ln, st = dense_inputs(20, 2, 24, 4, 2, 32, [0, 21])
    got = ref.flash_decode_plain(*to_torch(q, k, v, ln, st), 0.0,
                                 1.0 / 32 ** 0.5).numpy()
    assert not got[0].any()
    want = jref.flash_decode_ref(*map(jnp.asarray, (q, k, v, ln)))
    close(got[1], np.asarray(want)[1], ATOL_KERNEL)


def test_ops_flash_decode_on_cpu_is_the_plain_version():
    q, k, v, ln, st = to_torch(*dense_inputs(21, 2, 40, 4, 2, 32, [7, 30],
                                             window=9))
    before = ops.launch_counts()
    got = ops.flash_decode(q, k, v, ln, st, softcap=50.0)
    want = ref.flash_decode_plain(q, k, v, ln, st, 50.0, 1.0 / 32 ** 0.5)
    assert torch.equal(got, want)
    assert ops.launch_counts() == before
    assert ops.launch_counts()["flash_decode"] == tfd.flash_decode.launches


def test_flash_decode_wrapper_refuses_cpu_tensors():
    q, k, v, ln, st = to_torch(*dense_inputs(22, 2, 16, 4, 2, 32, [3, 9]))
    with pytest.raises(ValueError, match="CUDA kernel"):
        tfd.flash_decode(q, k, v, ln, st, 0.0, 1.0)


# --------------------------------------------------------------------------
# decode_step on a dense cache.
# --------------------------------------------------------------------------

def _dense_caches(jcfg, jp, prompt_len, room, seed):
    """Prefill two prompts with JAX into numpy caches with ``room`` free
    positions after the prompt.  Returns (first tokens, k, v, ssm, conv,
    pos); absent parts are None."""
    r = np.random.RandomState(seed)
    toks = r.randint(0, jcfg.vocab_size, (2, prompt_len)).astype(np.int32)
    logits, cache = jm.prefill(jp, jcfg, jnp.asarray(toks))
    k = v = ssm = conv = None
    if cache.k is not None:
        pad = ((0, 0), (0, 0), (0, room), (0, 0), (0, 0))
        k = np.pad(np.asarray(cache.k), pad)
        v = np.pad(np.asarray(cache.v), pad)
    if cache.ssm is not None:
        ssm, conv = np.asarray(cache.ssm), np.asarray(cache.conv)
    first = np.array(jnp.argmax(logits[:, :jcfg.vocab_size], -1), np.int32)
    return first, k, v, ssm, conv, np.full(2, prompt_len, np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_jax(arch):
    """Eight greedy steps from a 60-token prefill (crossing gemma2-smoke's
    64-token local window): logits, caches and SSM rows after each step
    within ATOL, tokens equal."""
    jcfg, jp, cfg, tp = _weights(arch)
    first, *parts = _dense_caches(jcfg, jp, 60, 8, seed=23)
    jcache = jm.DecodeCache(*(None if a is None else jnp.asarray(a)
                              for a in parts))
    cache = tm.DecodeCache(*(None if a is None else torch.from_numpy(a.copy())
                             for a in parts))
    jtok, tok = jnp.asarray(first), torch.from_numpy(first)
    for _ in range(8):
        jlogits, jcache = jm.decode_step(jp, jcfg, jtok, jcache)
        logits, new = tm.decode_step(tp, cfg, tok, cache)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   atol=ATOL, rtol=0)
        for name in ("k", "v", "ssm", "conv"):
            got = getattr(new, name)
            assert got is getattr(cache, name), name     # written in place
            if got is not None:
                np.testing.assert_allclose(
                    got.numpy(), np.asarray(getattr(jcache, name)),
                    atol=ATOL, rtol=0)
        np.testing.assert_array_equal(new.pos.numpy(), np.asarray(jcache.pos))
        cache = new
        jtok = jnp.argmax(jlogits[:, :jcfg.vocab_size], -1).astype(jnp.int32)
        tok = torch.argmax(logits[:, :cfg.vocab_size], -1).to(torch.int32)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))


# --------------------------------------------------------------------------
# The dense-gather engine.
# --------------------------------------------------------------------------

def test_gather_dense_and_write_token_match_jax():
    jcfg, _, cfg, _ = _weights("yi-9b")
    kw = dict(num_blocks=24, block_size=4, max_seqs=3, max_blocks_per_seq=8)
    j = jkv.PagedKVCache.create(jcfg, dtype=jnp.float32, **kw)
    t = tkv.PagedKVCache.create(cfg, dtype=torch.float32, device="cpu", **kw)
    r = np.random.RandomState(24)
    L, Hkv, D = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    seqs = {0: r.randn(L, 9, Hkv, D), 2: r.randn(L, 6, Hkv, D)}
    new = r.randn(2, L, 2, Hkv, D).astype(np.float32)
    slots = np.array([0, 2])
    for c, put in ((j, jnp.asarray), (t, torch.from_numpy)):
        for s, kv in seqs.items():
            c.admit(s, kv.shape[1], total_tokens=12)
            c.write_prefill(s, put(kv.astype(np.float32)),
                            put(-kv.astype(np.float32)))
        c.extend_for(0, 1)
        c.extend_for(2, 1)
        c.write_token(slots, put(new[0]), put(new[1]), np.array([9, 6]))
    got = t.gather_dense(slots, 10)
    assert got[0].shape == (L, 2, 10, Hkv, D)
    # decode_attention hands the kernel one layer's slice of the gather
    assert got[0].is_contiguous() and got[1].is_contiguous()
    for jt, tt in zip(j.gather_dense(slots, 10), got):
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(t.k.numpy(), np.asarray(j.k))
    np.testing.assert_array_equal(t.v.numpy(), np.asarray(j.v))


def _dense_job(engine, vocab):
    """Three requests over two slots, one of them decoding past
    gemma2-smoke's 64-token local window."""
    rng = np.random.RandomState(25)
    for rid, (n, new) in enumerate(((60, 8), (20, 6), (33, 5))):
        engine.submit(rid, rng.randint(0, vocab, n).astype(np.int32), new)
    return {r.rid: list(r.generated) for r in engine.run_to_completion()}


@pytest.mark.parametrize("arch", ARCHS)
def test_dense_engine_matches_jax(arch):
    jcfg, jp, cfg, tp = _weights(arch)
    kw = dict(num_blocks=64, block_size=8, max_seqs=2, decode_mode="dense")
    jeng = JaxEngine(jcfg, jp, **kw)
    want = _dense_job(jeng, jcfg.vocab_size)
    eng = ServingEngine(cfg, tp, device="cpu", **kw)
    got = _dense_job(eng, cfg.vocab_size)
    assert got == want
    # the dense path syncs every step and counts no decode_syncs
    assert _counters(eng) == _counters(jeng)
    assert eng.decode_syncs == 0 and eng.horizon_counts == {}
    _device_state_close(eng, jeng)
    # and the paged engine serves the same tokens
    paged = ServingEngine(cfg, tp, device="cpu",
                          **dict(kw, decode_mode="paged"))
    assert _dense_job(paged, cfg.vocab_size) == got


def test_dense_mode_refuses_a_horizon():
    _, _, cfg, tp = _weights("yi-9b")
    with pytest.raises(ValueError, match="decode_mode='paged'"):
        ServingEngine(cfg, tp, device="cpu", decode_mode="dense",
                      decode_horizon=4)
    with pytest.raises(ValueError, match="decode_mode"):
        ServingEngine(cfg, tp, device="cpu", decode_mode="sparse")

