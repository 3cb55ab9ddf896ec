"""The port's plain kernel versions against the JAX package's oracles and
its Pallas kernels in interpret mode.  (Each CUDA kernel against its plain
version on the card: ``test_torch_kernels_gpu.py``.)

Inputs are made with numpy from a seed and handed to both packages.  On the
CPU every comparison is fp32 with ATOL = 3e-5: both sides compute the same
function in fp32 and differ only in summation order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_kernels_gpu import (PAGED_CASES, PAGED_IDS, SSD_CASES,
                                    close, flash_inputs, paged_inputs,
                                    ssd_inputs, to_torch)

from repro.kernels import flash_decode as jfd
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import flash_decode as tfd
from repro_torch.kernels import ssd_scan as tssd

ATOL = 3e-5


def _close(a, b):
    close(a, b, ATOL)


# --------------------------------------------------------------------------
# Paged decode (B1).
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name,B,Hq,Hkv,D,page,lens,cap,win,trash",
                         PAGED_CASES, ids=PAGED_IDS)
def test_paged_decode_plain_matches_jax(name, B, Hq, Hkv, D, page, lens, cap,
                                        win, trash):
    q, kp, vp, tb, ln, st = paged_inputs(1, B, Hq, Hkv, D, page, lens,
                                         window=win, trash_rows=trash)
    got = ref.paged_decode_plain(*to_torch(q, kp, vp, tb, ln, st), cap,
                                 1.0 / D ** 0.5).numpy()
    kernel = jfd.flash_decode_paged_native(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tb),
        jnp.asarray(ln), start=jnp.asarray(st), softcap=cap, interpret=True)
    _close(got, kernel)
    # the JAX oracle reads page-major pools [P, page, Hkv, D]
    oracle = jref.flash_decode_paged_ref(
        jnp.asarray(q), jnp.asarray(kp.transpose(0, 2, 1, 3)),
        jnp.asarray(vp.transpose(0, 2, 1, 3)), jnp.asarray(tb),
        jnp.asarray(ln), softcap=cap, start=jnp.asarray(st))
    _close(got, oracle)


def test_paged_decode_len0_is_zero_like_the_kernel():
    """At len == 0 the Pallas kernel (and the port) return 0; the JAX
    oracle's all-masked softmax would return the mean of V instead, so this
    case is held against the interpret-mode kernel only."""
    q, kp, vp, tb, ln, st = paged_inputs(2, 2, 4, 2, 32, 8, [0, 21])
    got = ref.paged_decode_plain(*to_torch(q, kp, vp, tb, ln, st), 0.0,
                                 1.0 / 32 ** 0.5).numpy()
    kernel = jfd.flash_decode_paged_native(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tb),
        jnp.asarray(ln), start=jnp.asarray(st), interpret=True)
    _close(got, kernel)
    assert not got[0].any()


def test_ops_paged_decode_on_cpu_is_the_plain_version():
    q, kp, vp, tb, ln, st = paged_inputs(3, 2, 4, 2, 32, 8, [7, 30],
                                         window=9)
    args = to_torch(q, kp, vp, tb, ln, st)
    before = ops.launch_counts()
    got = ops.paged_decode(*args, softcap=50.0)
    want = ref.paged_decode_plain(*args, 50.0, 1.0 / 32 ** 0.5)
    assert torch.equal(got, want)
    assert ops.launch_counts() == before


DECODE_CASES = [
    (3, 256, 4, 2, 64),
    (2, 128, 8, 8, 128),
    (2, 100, 4, 1, 64),
    (1, 64, 25, 5, 64),
]


@pytest.mark.parametrize("B,S,Hq,Hkv,D", DECODE_CASES)
def test_flash_decode_ref_matches_jax(B, S, Hq, Hkv, D):
    r = np.random.RandomState(4)
    q = (r.randn(B, Hq, D) * 0.5).astype(np.float32)
    k = (r.randn(B, S, Hkv, D) * 0.5).astype(np.float32)
    v = (r.randn(B, S, Hkv, D) * 0.5).astype(np.float32)
    lens = r.randint(1, S + 1, B).astype(np.int32)
    start = (r.randint(0, 2, B) * (lens // 3)).astype(np.int32)
    got = ref.flash_decode_ref(*to_torch(q, k, v, lens), softcap=30.0,
                               start=torch.from_numpy(start))
    want = jref.flash_decode_ref(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), jnp.asarray(lens),
                                 softcap=30.0, start=jnp.asarray(start))
    _close(got.numpy(), want)


def test_flash_decode_paged_ref_matches_jax():
    r = np.random.RandomState(5)
    B, pages, page, Hkv, Hq, D, maxp = 3, 32, 16, 2, 4, 64, 8
    q = (r.randn(B, Hq, D) * 0.5).astype(np.float32)
    kp = (r.randn(pages, page, Hkv, D) * 0.5).astype(np.float32)
    vp = (r.randn(pages, page, Hkv, D) * 0.5).astype(np.float32)
    tbl = r.randint(0, pages, (B, maxp)).astype(np.int32)
    lens = r.randint(1, maxp * page, B).astype(np.int32)
    got = ref.flash_decode_paged_ref(*to_torch(q, kp, vp, tbl, lens))
    want = jref.flash_decode_paged_ref(*map(jnp.asarray,
                                            (q, kp, vp, tbl, lens)))
    _close(got.numpy(), want)
    # the same pools in kernel-native layout through the kernel's plain
    # version give the same answer
    native = ref.paged_decode_plain(
        *to_torch(q, kp.transpose(0, 2, 1, 3), vp.transpose(0, 2, 1, 3), tbl,
                lens, np.zeros_like(lens)), 0.0, 1.0 / D ** 0.5)
    _close(native.numpy(), want)


# --------------------------------------------------------------------------
# Causal prefill (B2).
# --------------------------------------------------------------------------

FLASH_CASES = [
    # B, S, Hq, Hkv, D, softcap, window
    (2, 256, 4, 2, 64, 0.0, 0),
    (1, 128, 8, 8, 128, 50.0, 0),
    (2, 256, 4, 4, 64, 0.0, 64),
    (1, 200, 6, 2, 96, 0.0, 0),
    (1, 128, 2, 1, 256, 0.0, 0),
    (1, 72, 8, 1, 32, 0.0, 0),        # group 8, ragged S
    (1, 96, 25, 5, 64, 0.0, 0),       # hymba heads, group 5
]


@pytest.mark.parametrize("B,S,Hq,Hkv,D,cap,win", FLASH_CASES)
def test_flash_attention_ref_matches_jax(B, S, Hq, Hkv, D, cap, win):
    q, k, v = flash_inputs(6, B, S, S, Hq, Hkv, D)
    got = ref.flash_attention_ref(*to_torch(q, k, v), softcap=cap,
                                  window=win).numpy()
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    _close(got, jref.flash_attention_ref(jq, jk, jv, softcap=cap,
                                         window=win))
    _close(got, jops.flash_attention(jq, jk, jv, softcap=cap, window=win,
                                     interpret=True))


def test_flash_attention_ref_noncausal_ragged_matches_jax_oracle():
    """Non-causal, Sq != Sk: held against the oracle only, since the JAX
    padding wrapper lets padded keys leak when causal is off."""
    q, k, v = flash_inputs(7, 2, 40, 70, 4, 2, 32)
    got = ref.flash_attention_ref(*to_torch(q, k, v), causal=False).numpy()
    _close(got, jref.flash_attention_ref(*map(jnp.asarray, (q, k, v)),
                                         causal=False))


def test_ops_flash_attention_on_cpu_is_the_plain_version():
    args = to_torch(*flash_inputs(8, 1, 24, 24, 4, 2, 32))
    before = ops.launch_counts()
    got = ops.flash_attention(*args, softcap=50.0, window=8)
    assert torch.equal(got, ref.flash_attention_ref(*args, softcap=50.0,
                                                    window=8))
    assert ops.launch_counts() == before


# --------------------------------------------------------------------------
# SSD chunk (B4).
# --------------------------------------------------------------------------

SSD_REF_CASES = [
    (2, 3, 64, 4, 64, 32),
    (1, 2, 128, 2, 64, 128),
    (1, 1, 64, 8, 32, 16),
]


@pytest.mark.parametrize("B,Nc,Q,H,P,N", SSD_REF_CASES)
def test_ssd_chunk_ref_matches_jax(B, Nc, Q, H, P, N):
    r = np.random.RandomState(9)
    x = (r.randn(B, Nc, Q, H, P) * 0.3).astype(np.float32)
    dt = (np.abs(r.randn(B, Nc, Q, H) * 0.05) + 0.01).astype(np.float32)
    A = (-np.abs(r.randn(H))).astype(np.float32)
    Bm = (r.randn(B, Nc, Q, H, N) * 0.3).astype(np.float32)
    Cm = (r.randn(B, Nc, Q, H, N) * 0.3).astype(np.float32)
    y, S = ref.ssd_chunk_ref(*to_torch(x, dt, A, Bm, Cm))
    args = tuple(map(jnp.asarray, (x, dt, A, Bm, Cm)))
    yr, Sr = jref.ssd_chunk_ref(*args)
    _close(y.numpy(), yr)
    _close(S.numpy(), Sr)


# the JAX package's kernel shapes (G = 1), then the port's own cases
SSD_PLAIN_CASES = [("jax-" + "-".join(map(str, c)), *c, 1)
                   for c in SSD_REF_CASES] + SSD_CASES


@pytest.mark.parametrize("name,B,Nc,Q,H,P,N,G", SSD_PLAIN_CASES,
                         ids=[c[0] for c in SSD_PLAIN_CASES])
def test_ssd_chunk_plain_matches_jax(name, B, Nc, Q, H, P, N, G):
    """The kernel's plain version takes B/C per group; JAX's oracle and its
    interpret-mode Pallas kernel take them broadcast to heads."""
    x, dt, A, Bm, Cm = ssd_inputs(14, B, Nc, Q, H, P, N, G)
    y, S = ref.ssd_chunk_plain(*to_torch(x, dt, A, Bm, Cm))
    Bh = np.repeat(Bm, H // G, axis=3)
    Ch = np.repeat(Cm, H // G, axis=3)
    args = tuple(map(jnp.asarray, (x, dt, A, Bh, Ch)))
    for yr, Sr in (jref.ssd_chunk_ref(*args),
                   jops.ssd_chunk(*args, interpret=True)):
        _close(y.numpy(), yr)
        _close(S.numpy(), Sr)


def test_ops_ssd_chunk_on_cpu_is_the_plain_version():
    args = to_torch(*ssd_inputs(15, 1, 2, 64, 8, 32, 16, 2))
    before = ops.launch_counts()
    got = ops.ssd_chunk(*args)
    want = ref.ssd_chunk_plain(*args)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert ops.launch_counts() == before


# --------------------------------------------------------------------------
# Wrappers and build, without a card.
# --------------------------------------------------------------------------


def test_kernel_wrappers_refuse_cpu_tensors():
    q, kp, vp, tb, ln, st = to_torch(*paged_inputs(10, 2, 4, 2, 32, 8,
                                                   [3, 9]))
    with pytest.raises(ValueError, match="CUDA kernel"):
        tfd.paged_decode(q, kp, vp, tb, ln, st, 0.0, 1.0)
    fq, fk, fv = to_torch(*flash_inputs(10, 1, 16, 16, 4, 2, 32))
    with pytest.raises(ValueError, match="CUDA kernel"):
        tfa.flash_attention(fq, fk, fv)
    with pytest.raises(ValueError, match="CUDA kernel"):
        tssd.ssd_chunk(*to_torch(*ssd_inputs(10, 1, 1, 16, 2, 16, 8)))


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.load("paged_decode")
