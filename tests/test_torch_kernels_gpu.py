"""Each of the port's CUDA kernels against its plain PyTorch version, on the
card.  Without a card every test here skips; on the card run

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

This file imports no JAX, so that it runs where only the port is
installed.  Its cases and seeded numpy inputs are shared with the CPU
tests of the plain versions against JAX (``test_torch_kernels.py``).
"""
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import flash_decode as tfd
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as tssd

PAGED_CASES = [
    # name, B, Hq, Hkv, D, page, lens, softcap, window, trash rows
    ("group2", 3, 4, 2, 32, 8, [5, 17, 40], 0.0, 0, ()),
    ("group1-ragged", 2, 4, 4, 32, 8, [13, 23], 0.0, 0, ()),
    ("group8-d128", 2, 8, 1, 128, 16, [1, 45], 0.0, 0, ()),
    ("softcap50", 2, 4, 2, 32, 8, [19, 33], 50.0, 0, ()),
    ("window-mid-page", 3, 4, 2, 32, 8, [10, 37, 64], 0.0, 12, ()),
    ("trash-row", 3, 4, 2, 32, 8, [9, 1, 30], 0.0, 0, (1,)),
    ("hymba-group5", 2, 25, 5, 64, 16, [20, 77], 0.0, 0, ()),
]
PAGED_IDS = [c[0] for c in PAGED_CASES]


def paged_inputs(seed, B, Hq, Hkv, D, page, lens, *, window=0,
                 trash_rows=()):
    """numpy q [B,Hq,D], kernel-native pools [P,Hkv,page,D] whose last page
    is the trash page, a table of distinct pages, lens and start."""
    r = np.random.RandomState(seed)
    lens = np.asarray(lens, np.int32)
    n_pages = max(1, (int(lens.max()) + page - 1) // page)
    P = B * n_pages + 1
    q = (r.randn(B, Hq, D) * 0.5).astype(np.float32)
    kp = (r.randn(P, Hkv, page, D) * 0.5).astype(np.float32)
    vp = (r.randn(P, Hkv, page, D) * 0.5).astype(np.float32)
    table = r.permutation(P - 1)[:B * n_pages].reshape(B, n_pages)
    table = table.astype(np.int32)
    for row in trash_rows:
        table[row] = P - 1
    start = (np.maximum(lens - window, 0) if window
             else np.zeros_like(lens)).astype(np.int32)
    return q, kp, vp, table, lens, start


DENSE_CASES = [
    # name, B, S, Hq, Hkv, D, lens, softcap, window
    ("group2", 3, 40, 4, 2, 32, [5, 17, 40], 0.0, 0),
    ("ragged-s", 2, 100, 4, 1, 64, [37, 100], 0.0, 0),
    ("softcap-window", 3, 64, 4, 2, 32, [10, 37, 64], 30.0, 12),
    ("hymba-group5", 2, 77, 25, 5, 64, [20, 77], 0.0, 0),
    ("gemma2-d256", 2, 130, 8, 4, 256, [61, 130], 50.0, 64),
]
DENSE_IDS = [c[0] for c in DENSE_CASES]


def dense_inputs(seed, B, S, Hq, Hkv, D, lens, *, window=0):
    """numpy q [B,Hq,D], dense caches k/v [B,S,Hkv,D], lens and start
    (the last ``window`` positions when ``window`` > 0)."""
    r = np.random.RandomState(seed)
    lens = np.asarray(lens, np.int32)
    q = (r.randn(B, Hq, D) * 0.5).astype(np.float32)
    k = (r.randn(B, S, Hkv, D) * 0.5).astype(np.float32)
    v = (r.randn(B, S, Hkv, D) * 0.5).astype(np.float32)
    start = (np.maximum(lens - window, 0) if window
             else np.zeros_like(lens)).astype(np.int32)
    return q, k, v, lens, start


# the dense decode kernel split over many CTAs: one sequence over a long
# cache, lens of 1 and S and off the 32-position tile, and a start inside
# a split and past whole splits (gemma2's window);
# name, B, S, Hq, Hkv, D, lens, starts
SPLIT_CASES = [
    ("batch1-long", 1, 4000, 32, 4, 128, [4000], [0]),
    ("batch1-len1", 1, 4000, 32, 4, 128, [1], [0]),
    ("ragged-lens-group8", 3, 1000, 8, 1, 64, [1, 333, 1000], [0, 0, 0]),
    ("start-inside-split", 2, 2048, 25, 5, 64, [2000, 1500], [700, 1300]),
    ("start-past-splits", 2, 2048, 8, 4, 256, [2048, 1030], [1900, 969]),
    ("group1-len0", 3, 300, 4, 4, 32, [0, 300, 45], [0, 0, 7]),
]
SPLIT_IDS = [c[0] for c in SPLIT_CASES]


def split_inputs(seed, B, S, Hq, Hkv, D, lens, starts):
    """numpy q [B,Hq,D], dense caches k/v [B,S,Hkv,D], lens and starts."""
    q, k, v, lens, _ = dense_inputs(seed, B, S, Hq, Hkv, D, lens)
    return q, k, v, lens, np.asarray(starts, np.int32)


# a prefill chunk after resident tokens:
# name, B, C (queries), offset, Hq, Hkv, D, softcap, window
CHUNK_CASES = [
    ("smoke", 1, 24, 40, 4, 2, 32, 0.0, 0),
    ("smoke-window", 2, 16, 50, 4, 2, 32, 50.0, 20),
    ("ragged-hymba", 1, 40, 77, 25, 5, 64, 0.0, 0),
]
CHUNK_IDS = [c[0] for c in CHUNK_CASES]


def flash_inputs(seed, B, Sq, Sk, Hq, Hkv, D):
    r = np.random.RandomState(seed)
    q = (r.randn(B, Sq, Hq, D) * 0.5).astype(np.float32)
    k = (r.randn(B, Sk, Hkv, D) * 0.5).astype(np.float32)
    v = (r.randn(B, Sk, Hkv, D) * 0.5).astype(np.float32)
    return q, k, v


SSD_CASES = [
    # name, B, Nc, Q, H, P, N, G
    ("smoke", 2, 2, 64, 4, 16, 16, 1),
    ("ragged-q", 1, 1, 100, 4, 32, 16, 1),
    ("groups2", 1, 2, 64, 8, 32, 16, 2),
    ("q1", 1, 3, 1, 2, 16, 8, 1),
]
SSD_IDS = [c[0] for c in SSD_CASES]


def ssd_inputs(seed, B, Nc, Q, H, P, N, G=1):
    """numpy x [B,Nc,Q,H,P], dt [B,Nc,Q,H] in the range softplus gives at
    init, A [H] < 0 and per-group B/C [B,Nc,Q,G,N]."""
    r = np.random.RandomState(seed)
    x = (r.randn(B, Nc, Q, H, P) * 0.3).astype(np.float32)
    dt = (np.abs(r.randn(B, Nc, Q, H) * 0.05) + 0.01).astype(np.float32)
    A = (-np.abs(r.randn(H))).astype(np.float32)
    Bm = (r.randn(B, Nc, Q, G, N) * 0.3).astype(np.float32)
    Cm = (r.randn(B, Nc, Q, G, N) * 0.3).astype(np.float32)
    return x, dt, A, Bm, Cm


def to_torch(*arrays, device="cpu"):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in arrays]


# fp32: the kernel sums in another order than the plain version, so the
# two agree to an absolute 1e-4.  bf16: both compute in fp32 and round the
# result to 8 significant bits, so an element may differ by one bf16 step,
# at most 2^-7 of the largest |value| in its output row; the limit is 1e-2
# of that row maximum, which keeps the check tight on long rows, whose
# attention output is small.
ATOL_FP32 = 1e-4
ROW_RTOL_BF16 = 1e-2
# the SSD chunk kernel is fp32 only; each output is a sum of up to Q = 256
# exp-weighted products whose size grows with the chunk, so the limit is
# relative to the output row's largest |value| (a row is y[t, :] or
# S[p, :]): fp32 sums of 256 terms in another order differ by ~1e-6 of it
ROW_RTOL_SSD = 1e-4


def close(a, b, atol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), atol=atol, rtol=0)


def row_rel_err(got, want) -> float:
    """Largest |got - want| of an output row over the row's largest
    |want|, rows along the last axis."""
    got = got.float().cpu().numpy()
    want = want.float().cpu().numpy()
    d = got.shape[-1]
    err = np.abs(got - want).reshape(-1, d).max(-1)
    row_max = np.maximum(np.abs(want).reshape(-1, d).max(-1), 1e-30)
    assert np.isfinite(got).all()
    return float((err / row_max).max())


def kernel_close(got, want, dtype):
    if dtype == torch.float32:
        close(got.float().cpu().numpy(), want.float().cpu().numpy(),
              ATOL_FP32)
        return
    rel = row_rel_err(got, want)
    assert rel <= ROW_RTOL_BF16, rel


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name,B,Hq,Hkv,D,page,lens,cap,win,trash",
                         PAGED_CASES + [("len0", 2, 4, 2, 32, 8, [0, 21],
                                         0.0, 0, ())],
                         ids=PAGED_IDS + ["len0"])
def test_paged_decode_kernel_matches_plain(cuda, dtype, name, B, Hq, Hkv, D,
                                           page, lens, cap, win, trash):
    q, kp, vp, tb, ln, st = to_torch(
        *paged_inputs(11, B, Hq, Hkv, D, page, lens, window=win,
                      trash_rows=trash), device=cuda)
    q, kp, vp = q.to(dtype), kp.to(dtype), vp.to(dtype)
    before = tfd.paged_decode.launches
    got = tfd.paged_decode(q, kp, vp, tb, ln, st, cap, 1.0 / D ** 0.5)
    torch.cuda.synchronize()
    assert tfd.paged_decode.launches == before + 1
    want = ref.paged_decode_plain(q, kp, vp, tb, ln, st, cap, 1.0 / D ** 0.5)
    kernel_close(got, want, dtype)


# the paged kernel split over pages at the served shapes: B = 8 mid-way
# through decode on a 64-page table (yi-9b's and hymba's heads) and one
# long sequence; name, B, Hq, Hkv, D, lens, n_pages
PAGED_SPLIT_SHAPES = [
    ("yi-9b", 8, 32, 4, 128, [336, 512, 700, 979, 963, 480, 820, 640], 64),
    ("hymba-1.5b", 8, 25, 5, 64, [336, 512, 700, 979, 963, 480, 820, 640],
     64),
    ("batch1-long", 1, 32, 4, 128, [2000], 128),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name,B,Hq,Hkv,D,lens,n_pages", PAGED_SPLIT_SHAPES,
                         ids=[c[0] for c in PAGED_SPLIT_SHAPES])
def test_paged_decode_kernel_many_splits_matches_plain(cuda, dtype, name, B,
                                                       Hq, Hkv, D, lens,
                                                       n_pages):
    """The split the wrapper picks from the table's width (more than one,
    at least one CTA per SM) against the unsplit plain version."""
    q, kp, vp, live, ln, st = to_torch(
        *paged_inputs(25, B, Hq, Hkv, D, 16, lens), device=cuda)
    q, kp, vp = q.to(dtype), kp.to(dtype), vp.to(dtype)
    # a table as wide as the engine's power-of-two bucket, its tail on
    # page 0
    tb = torch.zeros((B, n_pages), dtype=torch.int32, device=cuda)
    tb[:, :live.shape[1]] = live
    splits = tfd.split_count(B, Hkv, n_pages * 16, 16, tfd.sm_count(cuda))
    assert splits > 1 and B * Hkv * splits >= tfd.sm_count(cuda)
    before = tfd.paged_decode.launches
    got = tfd.paged_decode(q, kp, vp, tb, ln, st, 0.0, 1.0 / D ** 0.5)
    torch.cuda.synchronize()
    assert tfd.paged_decode.launches == before + 1
    assert tfd.paged_decode.last_n_split == splits
    want = ref.paged_decode_plain(q, kp, vp, tb, ln, st, 0.0, 1.0 / D ** 0.5)
    kernel_close(got, want, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_split", [1, 2, 5, 40])
def test_paged_decode_kernel_fixed_split_matches_split_plain(cuda, dtype,
                                                             n_split):
    """A fixed n_split, through the wrapper's private entry (40 is more
    than any row's live pages: empty splits), against the plain
    split-and-combine: a window, a trash-page row, rows of 1, 15, 16 and
    17 tokens and len == 0, whose row is zero."""
    q, kp, vp, tb, ln, st = to_torch(
        *paged_inputs(24, 7, 8, 2, 128, 16, [300, 17, 0, 16, 15, 1, 250],
                      window=100, trash_rows=(1,)), device=cuda)
    q, kp, vp = q.to(dtype), kp.to(dtype), vp.to(dtype)
    before = tfd.paged_decode.launches
    got = tfd._launch_paged(q, kp, vp, tb, ln, st, 30.0, 1.0 / 128 ** 0.5,
                            n_split)
    torch.cuda.synchronize()
    assert tfd.paged_decode.launches == before + 1
    assert tfd.paged_decode.last_n_split == n_split
    want = ref.paged_decode_split_plain(q, kp, vp, tb, ln, st, 30.0,
                                        1.0 / 128 ** 0.5, n_split)
    kernel_close(got, want, dtype)
    assert not got[2].float().any()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,causal,cap,win", [
    (2, 24, 24, 4, 2, 32, True, 0.0, 0),
    (1, 200, 200, 32, 4, 128, True, 0.0, 0),
    (2, 256, 256, 4, 4, 64, True, 0.0, 64),
    (1, 130, 130, 8, 4, 256, True, 50.0, 64),
    (2, 40, 70, 4, 2, 64, False, 0.0, 0),
    (1, 300, 300, 25, 5, 64, True, 0.0, 0),     # hymba heads, group 5
])
def test_flash_attention_kernel_matches_plain(cuda, dtype, B, Sq, Sk, Hq,
                                              Hkv, D, causal, cap, win):
    q, k, v = (t.to(dtype) for t in to_torch(
        *flash_inputs(12, B, Sq, Sk, Hq, Hkv, D), device=cuda))
    before = tfa.flash_attention.launches
    got = tfa.flash_attention(q, k, v, causal=causal, softcap=cap,
                              window=win)
    torch.cuda.synchronize()
    assert tfa.flash_attention.launches == before + 1
    want = ref.flash_attention_ref(q, k, v, causal=causal, softcap=cap,
                                   window=win)
    kernel_close(got, want, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name,B,S,Hq,Hkv,D,lens,cap,win", DENSE_CASES + [
    ("len0", 2, 24, 4, 2, 32, [0, 21], 0.0, 0),
    ("yi-9b", 8, 2048, 32, 4, 128, [1, 15, 16, 17, 300, 1000, 1500, 2048],
     0.0, 0),
    ("gemma2-2b", 4, 1030, 8, 4, 256, [3, 64, 517, 1030], 50.0, 61),
    ("hymba-1.5b", 8, 979, 25, 5, 64, [1, 15, 16, 17, 300, 600, 900, 979],
     0.0, 0),
], ids=DENSE_IDS + ["len0", "yi-9b", "gemma2-2b", "hymba-1.5b"])
def test_flash_decode_kernel_matches_plain(cuda, dtype, name, B, S, Hq, Hkv,
                                           D, lens, cap, win):
    q, k, v, ln, st = to_torch(
        *dense_inputs(16, B, S, Hq, Hkv, D, lens, window=win), device=cuda)
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    before = tfd.flash_decode.launches
    got = tfd.flash_decode(q, k, v, ln, st, cap, 1.0 / D ** 0.5)
    torch.cuda.synchronize()
    assert tfd.flash_decode.launches == before + 1
    want = ref.flash_decode_plain(q, k, v, ln, st, cap, 1.0 / D ** 0.5)
    kernel_close(got, want, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name,B,S,Hq,Hkv,D,lens,starts", SPLIT_CASES,
                         ids=SPLIT_IDS)
def test_flash_decode_kernel_many_splits_matches_plain(cuda, dtype, name, B,
                                                       S, Hq, Hkv, D, lens,
                                                       starts):
    """The split the wrapper picks for a small batch (many CTAs per
    sequence) against the unsplit plain version."""
    q, k, v, ln, st = to_torch(
        *split_inputs(21, B, S, Hq, Hkv, D, lens, starts), device=cuda)
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    splits = tfd.split_count(B, Hkv, S, tfd.TILE, tfd.sm_count(cuda))
    assert splits > 1
    before = tfd.flash_decode.launches
    got = tfd.flash_decode(q, k, v, ln, st, 0.0, 1.0 / D ** 0.5)
    torch.cuda.synchronize()
    assert tfd.flash_decode.launches == before + 1
    assert tfd.flash_decode.last_n_split == splits
    want = ref.flash_decode_plain(q, k, v, ln, st, 0.0, 1.0 / D ** 0.5)
    kernel_close(got, want, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_split", [1, 2, 5, 40])
def test_flash_decode_kernel_fixed_split_matches_split_plain(cuda, dtype,
                                                             n_split):
    """A fixed n_split, through the wrapper's private entry (40 is more
    than any row's live tiles: empty splits), against the plain
    split-and-combine."""
    q, k, v, ln, st = to_torch(
        *split_inputs(22, 3, 1000, 8, 2, 128, [1000, 517, 0], [0, 250, 0]),
        device=cuda)
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    before = tfd.flash_decode.launches
    got = tfd._launch(q, k, v, ln, st, 30.0, 1.0 / 128 ** 0.5, n_split)
    torch.cuda.synchronize()
    assert tfd.flash_decode.launches == before + 1
    assert tfd.flash_decode.last_n_split == n_split
    want = ref.flash_decode_split_plain(q, k, v, ln, st, 30.0,
                                        1.0 / 128 ** 0.5, n_split)
    kernel_close(got, want, dtype)
    assert not got[2].float().any()


# the prefill kernel at every head dim, Sq and Sk off the 64-row tile, with
# softcap, window, query offset and groups 5 and 8;
# B, Sq, Sk, q_offset, Hq, Hkv, D, causal, softcap, window
PREFILL_EDGE_CASES = [
    (2, 77, 77, 0, 8, 1, 32, True, 0.0, 0),
    (1, 100, 250, 150, 25, 5, 64, True, 0.0, 0),
    (1, 130, 330, 200, 32, 4, 128, True, 0.0, 50),
    (1, 99, 99, 0, 8, 4, 256, True, 50.0, 40),
    (2, 65, 129, 0, 16, 2, 128, False, 30.0, 0),
    (1, 70, 170, 100, 10, 2, 256, True, 0.0, 0),
    (1, 1, 45, 44, 40, 8, 64, True, 0.0, 0),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Sk,off,Hq,Hkv,D,causal,cap,win",
                         PREFILL_EDGE_CASES)
def test_flash_attention_kernel_edges_match_plain(cuda, dtype, B, Sq, Sk, off,
                                                  Hq, Hkv, D, causal, cap,
                                                  win):
    q, k, v = (t.to(dtype) for t in to_torch(
        *flash_inputs(23, B, Sq, Sk, Hq, Hkv, D), device=cuda))
    before = tfa.flash_attention.launches
    got = tfa.flash_attention(q, k, v, causal=causal, softcap=cap,
                              window=win, q_offset=off)
    torch.cuda.synchronize()
    assert tfa.flash_attention.launches == before + 1
    want = ref.flash_attention_ref(q, k, v, causal=causal, softcap=cap,
                                   window=win, q_offset=off)
    kernel_close(got, want, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name,B,C,off,Hq,Hkv,D,cap,win", CHUNK_CASES + [
    ("yi-9b", 1, 256, 512, 32, 4, 128, 0.0, 0),
    ("yi-9b-window", 1, 256, 512, 32, 4, 128, 0.0, 100),
    ("gemma2-2b", 1, 256, 512, 8, 4, 256, 50.0, 300),
], ids=CHUNK_IDS + ["yi-9b", "yi-9b-window", "gemma2-2b"])
def test_flash_attention_q_offset_kernel_matches_plain(cuda, dtype, name, B,
                                                       C, off, Hq, Hkv, D,
                                                       cap, win):
    """A chunk of C queries at positions off + [0, C) over the off + C
    keys before and in it."""
    q, k, v = (t.to(dtype) for t in to_torch(
        *flash_inputs(17, B, C, off + C, Hq, Hkv, D), device=cuda))
    before = tfa.flash_attention.launches
    got = tfa.flash_attention(q, k, v, softcap=cap, window=win,
                              q_offset=off)
    torch.cuda.synchronize()
    assert tfa.flash_attention.launches == before + 1
    want = ref.flash_attention_ref(q, k, v, softcap=cap, window=win,
                                   q_offset=off)
    kernel_close(got, want, dtype)


def unaligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` whose data starts one element past a
    16-byte boundary (the wrapper's checks accept it)."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("name,B,Nc,Q,H,P,N,G", SSD_CASES + [
    ("mamba2", 1, 4, 256, 32, 64, 128, 1),
    ("hymba", 1, 4, 256, 25, 64, 16, 1),
    ("q300-groups2", 1, 2, 300, 6, 64, 128, 2),
    ("q1024-p128", 1, 1, 1024, 4, 128, 64, 1),
    ("ragged-n13", 1, 2, 130, 8, 32, 13, 2),
    ("n200-p128", 1, 1, 256, 4, 128, 200, 1),
    ("unaligned", 1, 2, 100, 4, 64, 16, 1),
], ids=SSD_IDS + ["mamba2", "hymba", "q300-groups2", "q1024-p128",
                  "ragged-n13", "n200-p128", "unaligned"])
def test_ssd_chunk_kernel_matches_plain(cuda, name, B, Nc, Q, H, P, N, G):
    """Beyond the served shapes: Q > 256, P = 128, state widths off the
    4-float row (4-byte staging) and inputs off a 16-byte boundary."""
    x, dt, A, Bm, Cm = to_torch(*ssd_inputs(13, B, Nc, Q, H, P, N, G),
                                device=cuda)
    if name == "unaligned":
        x, dt, A, Bm, Cm = (unaligned(t) for t in (x, dt, A, Bm, Cm))
    before = tssd.ssd_chunk.launches
    y, S = tssd.ssd_chunk(x, dt, A, Bm, Cm)
    torch.cuda.synchronize()
    assert tssd.ssd_chunk.launches == before + 1
    y_want, S_want = ref.ssd_chunk_plain(x, dt, A, Bm, Cm)
    assert row_rel_err(y, y_want) <= ROW_RTOL_SSD
    assert row_rel_err(S, S_want) <= ROW_RTOL_SSD


@pytest.mark.gpu
@pytest.mark.parametrize("Q,H,P,N,n", [
    (256, 25, 64, 16, 203),     # hymba, a prefill's last chunk
    (256, 32, 64, 128, 77),     # mamba2
    (100, 4, 32, 16, 9),
], ids=["hymba", "mamba2", "ragged-q"])
def test_ssd_chunk_kernel_rows_do_not_depend_on_later_rows(cuda, Q, H, P,
                                                           N, n):
    """y's first n rows are bit-equal whether the rows after them hold
    zeros (a prefill's padded tail) or real tokens: a re-prefill of a
    context must leave the state a longer forward computes for it."""
    x, dt, A, Bm, Cm = to_torch(*ssd_inputs(17, 1, 1, Q, H, P, N),
                                device=cuda)
    cut = [t.clone() for t in (x, dt, Bm, Cm)]
    for t in cut:
        t[:, :, n:] = 0
    y, _ = tssd.ssd_chunk(x, dt, A, Bm, Cm)
    y_cut, _ = tssd.ssd_chunk(cut[0], cut[1], A, cut[2], cut[3])
    assert torch.equal(y[:, :, :n], y_cut[:, :, :n])


# --------------------------------------------------------------------------
# KV migration on the card: the engine's page moves and the streams that
# resume after them (smoke configs; the CPU parity against the JAX package
# is ``test_torch_migration.py``).
# --------------------------------------------------------------------------

# (arch, path): every restore path of each model family; mamba2 keeps no
# pages, so it has none to re-lay out
MIGRATIONS = [(arch, path) for arch in ("yi-9b", "hymba-1.5b", "mamba2-370m")
              for path in ("handoff", "copy", "relayout", "reprefill")
              if (arch, path) != ("mamba2-370m", "relayout")]


def _chip_smoke():
    """``chip_smoke.py``, whose migration driver these tests share."""
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _migrate(device, arch, path, dtype):
    """Serve three seeded requests two steps on a source engine, move them
    by ``path`` (relayout: to 4-token pages) and finish on the destination.
    Returns the migrated streams, the uninterrupted ones, the report, and
    each request's K/V gathered from its pages just before the export and
    just after the move ({rid: (k, v)}; handoff, copy and relayout)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params
    from repro_torch.serving.engine import ServingEngine
    cs = _chip_smoke()
    cfg = get_smoke_config(arch)
    params = init_params(cfg, seed=0, dtype=dtype, device=device)
    rng = np.random.RandomState(5)
    jobs = {rid: (rng.randint(0, cfg.vocab_size, n).astype(np.int32), new)
            for rid, (n, new) in enumerate(((40, 10), (13, 12), (27, 9)))}
    ref_eng = ServingEngine(cfg, params, num_blocks=128, block_size=8,
                            max_seqs=4, dtype=dtype, device=device)
    for rid, (p, n) in jobs.items():
        ref_eng.submit(rid, p, n)
    want = {r.rid: r.generated for r in ref_eng.run_to_completion()}
    src, dst = cs.migration_engines(cfg, params, device, path,
                                    num_blocks=64, block_size=8, max_seqs=4,
                                    dtype=dtype)
    got = cs.serve_part_way(src, jobs, steps=2)
    before = {} if path == "reprefill" else cs.kv_in_flight(src)
    report = cs.move_inflight(src, dst, path).report
    after = cs.kv_in_flight(dst)
    got.update({r.rid: r.generated for r in dst.run_to_completion()})
    return got, want, report, before, after


@pytest.mark.gpu
@pytest.mark.parametrize("path", ["handoff", "copy", "relayout"])
@pytest.mark.parametrize("arch", ["yi-9b", "hymba-1.5b"])
def test_page_moves_are_bit_exact_on_the_card(cuda, arch, path):
    _, _, report, before, after = _migrate(cuda, arch, path, torch.bfloat16)
    assert report.migrated == 3 and report.recompute_tokens == 0
    assert sorted(before) == sorted(after) == [0, 1, 2]
    for rid in before:
        for b, a in zip(before[rid], after[rid]):
            assert b.shape == a.shape and torch.equal(b, a), rid


@pytest.mark.gpu
@pytest.mark.parametrize("arch,path", MIGRATIONS)
def test_migrated_stream_equals_uninterrupted_on_the_card(cuda, arch, path):
    got, want, report, _, _ = _migrate(cuda, arch, path, torch.float32)
    assert got == want
    expect = {"handoff": "handoff", "copy": "copied", "relayout": "copied",
              "reprefill": "reprefilled"}[path]
    assert getattr(report, expect) == 3


# --------------------------------------------------------------------------
# The prefix cache's host tier and shared pages on the card.
# --------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_host_tier_round_trip_is_bit_exact_on_the_card(cuda, dtype):
    """Evict cached pages through pinned host memory, overwrite the blocks
    they freed, restore them through ``attach``: every byte comes back."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.serving.kvcache import (BlockPool, gather_tokens,
                                             scatter_tokens)
    from repro_torch.serving.prefixcache import PrefixCache
    cfg = get_smoke_config("yi-9b")
    bs, n = 8, 3
    pool = BlockPool(cfg, 6, bs, dtype, device=cuda)
    pc = PrefixCache(pool)
    blocks = pool.allocator.alloc(n)
    g = torch.Generator(device=cuda)
    g.manual_seed(7)
    shape = (cfg.n_layers, n * bs, cfg.n_kv_heads, cfg.head_dim)
    k = torch.randn(shape, generator=g, device=cuda).to(dtype)
    v = torch.randn(shape, generator=g, device=cuda).to(dtype)
    scatter_tokens(pool, blocks, k, v)
    tokens = np.random.RandomState(7).randint(0, 100, n * bs).astype(np.int32)
    pc.publish(tokens, blocks)
    pool.allocator.release(blocks)          # the index's references remain
    pc.reclaim(pool.num_blocks)             # every cold page to the host
    entries = list(pc.index.values())
    assert all(e.block is None and e.host.is_pinned() for e in entries)
    assert pc.evicted_bytes == n * pool.page_nbytes
    # the freed blocks are reallocated and overwritten
    again = pool.allocator.alloc(pool.num_blocks)
    scatter_tokens(pool, again, torch.zeros(
        (cfg.n_layers, pool.num_blocks * bs, cfg.n_kv_heads, cfg.head_dim),
        dtype=dtype, device=cuda), torch.ones(
        (cfg.n_layers, pool.num_blocks * bs, cfg.n_kv_heads, cfg.head_dim),
        dtype=dtype, device=cuda))
    pool.allocator.release(again)
    cached, shared, cow = pc.attach(pc.match(tokens, n * bs))
    assert cached == n * bs and cow is None
    assert pc.restored_bytes == n * pool.page_nbytes
    k2, v2 = gather_tokens(pool, shared, n * bs)
    torch.cuda.synchronize()
    assert torch.equal(k2, k) and torch.equal(v2, v)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hits_leave_the_shared_pages_unchanged_on_the_card(cuda, dtype):
    """A shared-template job through the prefill kernel's resumed prefill
    and the paged decode kernel: the pages request 0 published are the
    same bytes after the hits (tails and a retry that copies on write)
    prefilled and decoded over them; in fp32 the streams equal the
    cache-off run's."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params
    from repro_torch.serving.kvcache import gather_tokens
    cs = _chip_smoke()
    cfg = get_smoke_config("yi-9b")
    params = init_params(cfg, seed=0, dtype=dtype, device=cuda)
    prompts = cs.prefix_prompts(cfg, 4, 24, 8, 6)
    published = {}

    def keep(eng):
        pool = eng.cache.pool
        published.update({key: gather_tokens(pool, [e.block], 8)
                          for key, e in eng.prefix_cache.index.items()})

    kw = dict(num_blocks=128, block_size=8, max_seqs=4, dtype=dtype,
              decode_horizon=8)
    fin, eng, _ = cs.serve_prefix_job(cfg, params, prompts, 12, cuda,
                                      after_first=keep, prefix_cache=True,
                                      **kw)
    pc, pool = eng.prefix_cache, eng.cache.pool
    assert pc.hits == len(prompts) - 1 and published
    for key, kv in published.items():
        got = gather_tokens(pool, [pc.index[key].block], 8)
        assert all(torch.equal(a, b) for a, b in zip(got, kv))
    if dtype == torch.float32:
        off, _, _ = cs.serve_prefix_job(cfg, params, prompts, 12, cuda,
                                        prefix_cache=False, **kw)
        assert ({r: fin[r].generated for r in fin}
                == {r: off[r].generated for r in off})


# --------------------------------------------------------------------------
# The cluster on the card: the smoke twin of ``chip_smoke.py`` phase 5's
# cluster job (the CPU parity against the JAX package is
# ``test_torch_cluster*.py``).
# --------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("lose_pages", [False, True], ids=["keep", "lose"])
@pytest.mark.parametrize("arch", ["yi-9b", "hymba-1.5b"])
def test_cluster_switch_and_crash_on_the_card(cuda, arch, lose_pages):
    """A switch with requests in flight and a replica crash give the same
    tokens and counts on the card as on the CPU (fp32)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params
    cs = _chip_smoke()
    cfg = get_smoke_config(arch)
    params = init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    got = {dev: cs.switch_crash_twin(cs.cluster_package(dev), cfg,
                                     cs._to(params, dev),
                                     lose_pages=lose_pages, decode_horizon=4)
           for dev in ("cpu", cuda.type)}
    card = got[cuda.type]
    assert card == got["cpu"]
    sw, rec = card["switch"], card["recovery"]
    assert not sw["rolled_back"] and sw["handoff"] == sw["migrated"] >= 1
    assert rec["reprefilled" if lose_pages else "handoff"] >= 1
    assert card["pool"] == (128, 0)
