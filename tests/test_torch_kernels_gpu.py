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
from repro_torch.kernels import flash_attention_bwd as tfab
from repro_torch.kernels import flash_decode as tfd
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_chunk_bwd as tssb
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


@pytest.fixture
def no_tf32(monkeypatch):
    """fp32 matmuls on the card without TF32 for one test, restored after
    it, so that no later test in the process depends on the order."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)


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
    before = tfd.paged_decode.counter["launches"]
    got = tfd.paged_decode(q, kp, vp, tb, ln, st, cap, 1.0 / D ** 0.5)
    torch.cuda.synchronize()
    assert tfd.paged_decode.counter["launches"] == before + 1
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
    before = tfd.paged_decode.counter["launches"]
    got = tfd.paged_decode(q, kp, vp, tb, ln, st, 0.0, 1.0 / D ** 0.5)
    torch.cuda.synchronize()
    assert tfd.paged_decode.counter["launches"] == before + 1
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
    before = tfd.paged_decode.counter["launches"]
    got = tfd._launch_paged(q, kp, vp, tb, ln, st, 30.0, 1.0 / 128 ** 0.5,
                            n_split)
    torch.cuda.synchronize()
    assert tfd.paged_decode.counter["launches"] == before + 1
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
    before = tfa.flash_attention.counter["launches"]
    got = tfa.flash_attention(q, k, v, causal=causal, softcap=cap,
                              window=win)
    torch.cuda.synchronize()
    assert tfa.flash_attention.counter["launches"] == before + 1
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
    before = tfd.flash_decode.counter["launches"]
    got = tfd.flash_decode(q, k, v, ln, st, cap, 1.0 / D ** 0.5)
    torch.cuda.synchronize()
    assert tfd.flash_decode.counter["launches"] == before + 1
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
    before = tfd.flash_decode.counter["launches"]
    got = tfd.flash_decode(q, k, v, ln, st, 0.0, 1.0 / D ** 0.5)
    torch.cuda.synchronize()
    assert tfd.flash_decode.counter["launches"] == before + 1
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
    before = tfd.flash_decode.counter["launches"]
    got = tfd._launch(q, k, v, ln, st, 30.0, 1.0 / 128 ** 0.5, n_split)
    torch.cuda.synchronize()
    assert tfd.flash_decode.counter["launches"] == before + 1
    assert tfd.flash_decode.last_n_split == n_split
    want = ref.flash_decode_split_plain(q, k, v, ln, st, 30.0,
                                        1.0 / 128 ** 0.5, n_split)
    kernel_close(got, want, dtype)
    assert not got[2].float().any()


# B3's lse form (the decode plan's sequence shards): a data group's shard
# of a 544-position cache, the long context's shard of 12288 over 4 and
# one past the position, rows that attend nothing (len <= start, in the
# last live tile and past it) and gemma2-2b's heads with softcap and window;
# name, B, S, Hq, Hkv, D, lens, starts, softcap
LSE_CASES = [
    ("plans-shard", 4, 272, 32, 4, 128, [272, 256, 1, 0], [0, 0, 0, 0], 0.0),
    ("long-shard", 1, 3072, 32, 4, 128, [2065], [0], 0.0),
    ("long-past-pos", 1, 3072, 32, 4, 128, [0], [0], 0.0),
    ("empty-rows", 4, 300, 32, 4, 128, [100, 300, 45, 40], [200, 299, 40, 45],
     0.0),
    ("gemma2-window", 4, 1030, 8, 4, 256, [3, 64, 517, 1030],
     [0, 3, 456, 969], 50.0),
]
LSE_IDS = [c[0] for c in LSE_CASES]
LSE_ATOL = 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("n_split", [None, 1, 3, 40])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name,B,S,Hq,Hkv,D,lens,starts,cap", LSE_CASES,
                         ids=LSE_IDS)
def test_flash_decode_lse_matches_plain(cuda, dtype, n_split, name, B, S, Hq,
                                        Hkv, D, lens, starts, cap):
    """The lse form by the wrapper's split count and at fixed ones (the
    loop writes the lse with one split, the combine with several): the
    output as the plain version's and bit-equal to the kernel's without
    the lse, the lse within LSE_ATOL of the plain version's, zeros and
    -inf on rows that attend nothing; one launch, counted as lse."""
    q, k, v, ln, st = to_torch(
        *split_inputs(23, B, S, Hq, Hkv, D, lens, starts), device=cuda)
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    scale = 1.0 / D ** 0.5
    before = tfd.flash_decode.counter.read()
    if n_split is None:
        got, lse = tfd.flash_decode(q, k, v, ln, st, cap, scale,
                                    with_lse=True)
        plain = tfd.flash_decode(q, k, v, ln, st, cap, scale)
    else:
        got, lse = tfd._launch(q, k, v, ln, st, cap, scale, n_split,
                               with_lse=True)
        plain = tfd._launch(q, k, v, ln, st, cap, scale, n_split)
    torch.cuda.synchronize()
    after = tfd.flash_decode.counter.read()
    assert (after["launches"], after["lse_launches"]) == (
        before["launches"] + 2, before["lse_launches"] + 1)
    want, want_lse = ref.flash_decode_plain(q, k, v, ln, st, cap, scale,
                                            with_lse=True)
    kernel_close(got, want, dtype)
    assert torch.equal(got, plain)
    live = want_lse > -torch.inf
    assert torch.equal(lse > -torch.inf, live)
    close(lse[live].cpu().numpy(), want_lse[live].cpu().numpy(), LSE_ATOL)
    assert not got[~live].float().any()


def tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("B,dp", [(4, 2), (1, 2)], ids=["batch4", "batch1"])
def test_decode_plan_on_the_card_equals_the_cpu(cuda, no_tf32, B, dp):
    """yi-9b's smoke config, fp32: the prefill plan, ``reshard_cache`` and
    6 greedy steps of the decode plan on (data dp, model 2) virtual chips
    of the card give the CPU's tokens and logits within 1e-4, launching
    B2 and B3's lse form, never B1."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import ops
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import make_small_mesh
    from repro_torch.models import init_params, sharded
    cfg = get_smoke_config("yi-9b")
    S, steps = 40, 6
    tokens = torch.from_numpy(np.random.RandomState(4).randint(
        0, cfg.vocab_size, (B, S)).astype(np.int32))
    params = init_params(cfg, 0, torch.float32, "cpu")
    streams = {}
    for dev in ("cpu", cuda):
        mesh = make_small_mesh([dev] * (dp * 2), model=2)
        pplan, _ = shd.make_plan(cfg, "prefill", False, B, tp=2)
        dplan, _ = shd.make_plan(cfg, "decode", False, B, tp=2)
        p = tree_to(params, dev)
        pm = sharded.PlanModel.build(p, cfg, pplan, mesh)
        dm = sharded.PlanModel.build(p, cfg, dplan, mesh)
        ops.reset_launch_counts()
        logits, cache = sharded.prefill_plan(pm, [
            x["t"] for x in shd.shard_batch({"t": tokens.to(dev)}, pplan,
                                            mesh)])
        cache = shd.reshard_cache(cache, cfg, pplan, dplan, mesh,
                                  max_len=S + steps)
        out = [torch.cat(logits)]
        for _ in range(steps):
            tok = out[-1].argmax(-1).to(torch.int32)
            logits, cache = sharded.decode_step_plan(dm, [
                x["t"] for x in shd.shard_batch({"t": tok}, dplan, mesh)],
                cache)
            out.append(torch.cat(logits))
        streams[str(dev)] = [o.cpu() for o in out]
        counts = ops.launch_counts()
    for a, b in zip(streams["cpu"], streams[str(cuda)]):
        assert torch.equal(a.argmax(-1), b.argmax(-1))
        close(b.numpy(), a.numpy(), 1e-4)
    assert counts["flash_attention"] > 0 and counts["paged_decode"] == 0
    assert counts["flash_decode"] == counts["flash_decode_lse"] > 0


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
    before = tfa.flash_attention.counter["launches"]
    got = tfa.flash_attention(q, k, v, causal=causal, softcap=cap,
                              window=win, q_offset=off)
    torch.cuda.synchronize()
    assert tfa.flash_attention.counter["launches"] == before + 1
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
    before = tfa.flash_attention.counter["launches"]
    got = tfa.flash_attention(q, k, v, softcap=cap, window=win,
                              q_offset=off)
    torch.cuda.synchronize()
    assert tfa.flash_attention.counter["launches"] == before + 1
    want = ref.flash_attention_ref(q, k, v, softcap=cap, window=win,
                                   q_offset=off)
    kernel_close(got, want, dtype)


# the model families' served heads: opt-30b's and olmoe-1b-7b's MHA (a
# group of 1, D = 128) and granite-moe's 24/8 of 64 (a group of 3);
# name, Hq, Hkv, D
FAMILY_HEADS = [("opt-30b", 56, 56, 128), ("olmoe-1b-7b", 16, 16, 128),
                ("granite-moe", 24, 8, 64),
                # yi-9b's shard-local heads: tp 2 (16 over 2 KV heads, a
                # group of 8) and tp 8 (4 over one replicated KV head)
                ("yi-9b-tp2", 16, 2, 128), ("yi-9b-tp8", 4, 1, 128)]
FAMILY_IDS = [c[0] for c in FAMILY_HEADS]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name,Hq,Hkv,D", FAMILY_HEADS, ids=FAMILY_IDS)
def test_paged_decode_kernel_family_heads_match_plain(cuda, dtype, name, Hq,
                                                      Hkv, D):
    """B1 at the families' decode shape: B = 8 mid-way through decode on
    the engine's 64-page table, a trash-page row among them."""
    lens = [336, 512, 700, 979, 963, 480, 820, 640]
    q, kp, vp, live, ln, st = to_torch(
        *paged_inputs(31, 8, Hq, Hkv, D, 16, lens, trash_rows=(2,)),
        device=cuda)
    q, kp, vp = q.to(dtype), kp.to(dtype), vp.to(dtype)
    tb = torch.zeros((8, 64), dtype=torch.int32, device=cuda)
    tb[:, :live.shape[1]] = live
    before = tfd.paged_decode.counter["launches"]
    got = tfd.paged_decode(q, kp, vp, tb, ln, st, 0.0, 1.0 / D ** 0.5)
    torch.cuda.synchronize()
    assert tfd.paged_decode.counter["launches"] == before + 1
    want = ref.paged_decode_plain(q, kp, vp, tb, ln, st, 0.0, 1.0 / D ** 0.5)
    kernel_close(got, want, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name,Hq,Hkv,D", FAMILY_HEADS, ids=FAMILY_IDS)
def test_flash_attention_kernel_family_heads_match_plain(cuda, dtype, name,
                                                         Hq, Hkv, D):
    """B2 at the families' heads: a 300-token prompt, and a 256-token
    chunk at query offset 512."""
    for Sq, off in ((300, 0), (256, 512)):
        q, k, v = (t.to(dtype) for t in to_torch(
            *flash_inputs(32, 1, Sq, off + Sq, Hq, Hkv, D), device=cuda))
        before = tfa.flash_attention.counter["launches"]
        got = tfa.flash_attention(q, k, v, q_offset=off)
        torch.cuda.synchronize()
        assert tfa.flash_attention.counter["launches"] == before + 1
        want = ref.flash_attention_ref(q, k, v, q_offset=off)
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
    before = tssd.ssd_chunk.counter["launches"]
    y, S = tssd.ssd_chunk(x, dt, A, Bm, Cm)
    torch.cuda.synchronize()
    assert tssd.ssd_chunk.counter["launches"] == before + 1
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


@pytest.mark.gpu
@pytest.mark.parametrize("tp,pp", [(2, 1), (2, 2)])
def test_sharded_engine_on_the_card_equals_unsharded(cuda, no_tf32, tp, pp):
    """yi-9b smoke sharded over virtual chips on one card (fp32): the
    unsharded engine's tokens, B1 and B2 launched by the shards."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_replica_mesh
    from repro_torch.launch.sharding import make_plan
    from repro_torch.models import init_params
    from repro_torch.serving.engine import ServingEngine
    cfg = get_smoke_config("yi-9b")
    params = init_params(cfg, seed=0, dtype=torch.float32, device=cuda)
    rng = np.random.RandomState(0)
    jobs = [(rng.randint(0, cfg.vocab_size, n).astype(np.int32), new)
            for n, new in ((8, 7), (8, 9), (12, 6), (12, 8))]

    def serve(**kw):
        eng = ServingEngine(cfg, params, num_blocks=64, block_size=8,
                            max_seqs=4, device=cuda, decode_horizon=4, **kw)
        for i, (p, n) in enumerate(jobs):
            eng.submit(i, p, n)
        return {r.rid: r.generated for r in eng.run_to_completion()}

    want = serve()
    plan, _ = make_plan(cfg, "serve", False, 1, tp=tp, pp=pp)
    ops.reset_launch_counts()
    got = serve(mesh=make_replica_mesh([cuda] * (tp * pp), tp, pp),
                shard_plan=plan)
    counts = ops.launch_counts()
    assert got == want
    assert counts["paged_decode"] > 0 and counts["flash_attention"] > 0
    assert counts["flash_decode"] == 0


# --------------------------------------------------------------------------
# The control loop on the card: the workload predictor's LSTM and the
# orchestrated path (the CPU parity against the JAX package is
# ``test_torch_predictor.py`` and ``test_torch_orchestrated*.py``).
# --------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("window,hidden,epochs", [(3, 8, 40), (50, 32, 20)])
def test_lstm_predictions_on_the_card_equal_the_cpu(cuda, no_tf32, window,
                                                    hidden, epochs):
    """The LSTM trained and run on the card predicts what the same code
    predicts on the CPU, within a relative 1e-4 (fp32, TF32 off)."""
    from repro_torch.core.predictor import LSTMWorkloadPredictor
    from repro_torch.serve_orchestrated import forecast
    if window == 3:
        got, want = forecast(12, cuda.type), forecast(12, "cpu")
        w = got["window"]
        card, cpu = np.asarray(got["preds"][w:]), np.asarray(want["preds"][w:])
    else:
        series = np.random.RandomState(0).poisson(
            40, (120, 4)).astype(np.float64)
        fits = {}
        for dev in (cuda.type, "cpu"):
            lstm = LSTMWorkloadPredictor(4, window=window, hidden=hidden,
                                         seed=0, device=dev)
            lstm.fit(series, epochs=epochs)
            fits[dev] = lstm.predict_series(series)
        card, cpu = fits[cuda.type], fits["cpu"]
    assert card.shape == cpu.shape and len(card)
    assert np.abs(card - cpu).max() <= 1e-4 * np.abs(cpu).max()


@pytest.mark.gpu
def test_run_real_spans_on_the_card_equals_the_cpu(cuda, no_tf32):
    """``run_real_spans`` (llama2-70b smoke, 6 chips, 3 spans, a switch each
    span with requests in flight) gives the same plans, reports and tokens
    on the card as on the CPU (fp32)."""
    cs = _chip_smoke()
    card = cs.real_spans_twin(cuda.type)
    assert card == cs.real_spans_twin("cpu")
    assert sum(s["migrated"] for s in card["switches"]) >= 1
    assert len(card["tokens"]) == 18


@pytest.mark.gpu
def test_run_real_spans_opt_30b_on_the_card_equals_the_cpu(cuda, no_tf32):
    """``run_real_spans`` on the default model's smoke config, opt-30b
    (sinusoidal positions, biases, GELU; 6 chips, 3 spans): the same
    plans, reports and tokens on the card as on the CPU (fp32)."""
    cs = _chip_smoke()
    card = cs.real_spans_twin(cuda.type, "opt-30b")
    assert card == cs.real_spans_twin("cpu", "opt-30b")
    assert len(card["tokens"]) == 18


@pytest.mark.gpu
def test_moe_capacity_path_on_the_card_equals_the_cpu(cuda, no_tf32):
    """One olmoe-1b-7b MoE layer at its published widths on 4096 tokens in
    one group at capacity factor 1.25: the card drops the CPU's (token,
    slot) pairs and its output is the CPU's within 1e-4 (fp32); at a
    drop-free factor it is ``moe_ref``'s."""
    cs = _chip_smoke()
    r = cs.moe_capacity_twin()
    assert r["groups"] == 1 and r["dropped"] > 0 and r["same_drops"]
    assert r["max_abs_err"] <= 1e-4 and r["drop_free_err"] <= 1e-4
    assert r["changed_rows_are_dropped_rows"] and r["finite"]


# --------------------------------------------------------------------------
# The paper's evaluation on the card (``repro_torch.benchmarks``; the CPU
# parity against the JAX package is ``test_torch_evaluation*.py``).
# --------------------------------------------------------------------------


@pytest.mark.gpu
def test_lstm_in_the_loop_on_the_card_equals_the_cpu(cuda, no_tf32):
    """``OServePolicy`` with the LSTM in the loop (window 6, hidden 8) on
    ``Bench("opt-30b", 8, 10, 2)``: each span's prediction on the card is
    the CPU's within a relative 1e-4 (fp32, TF32 off)."""
    from repro_torch.benchmarks.common import Bench
    cs = _chip_smoke()
    bench = Bench("opt-30b", 8, n_spans=10, trace_id=2)
    card = cs.lstm_in_the_loop(bench, cuda.type)
    cpu = cs.lstm_in_the_loop(bench, "cpu")
    assert card["preds"].shape == cpu["preds"].shape == (4, 4)
    for got, want in zip(card["preds"], cpu["preds"]):
        assert np.abs(got - want).max() <= cs.LSTM_RTOL * np.abs(want).max()
    assert card["completed"] + card["dropped"] == len(bench.requests)


@pytest.mark.gpu
def test_real_validation_on_the_card_equals_the_cpu(cuda, no_tf32):
    """``bench_e2e.real_validation(n_spans=2)`` (opt-30b smoke, 6 chips):
    the card's rows are the CPU's but for the wall-clock fields (fp32)."""
    cs = _chip_smoke()
    rows, card = cs.real_validation_rows(cuda.type)
    assert card == cs.real_validation_rows("cpu")[1]
    assert len(rows) == 7 and "completed=12/12" in rows[2]


# B2's backward: name, B, S, Hq, Hkv, D, softcap, window (every head dim,
# groups of 1, 3, 5 and 8, ragged S, a window and a softcap).  The last
# three make the bf16 kernels' split show: a group of 8 summed over a
# cluster of 8 CTAs at an S that is no multiple of a tile (64 keys, 64 or
# 32 queries a step), hymba's group of 5 under a window, and gemma2-2b's
# D = 256 (two dK/dV passes, 32-row steps) with its softcap and a window
BWD_CASES = [
    ("d32-group1", 2, 77, 4, 4, 32, 0.0, 0),
    ("d64-group3", 2, 100, 12, 4, 64, 0.0, 0),
    ("d128-group8-cap", 1, 130, 32, 4, 128, 30.0, 0),
    ("d256-window-cap", 1, 99, 8, 4, 256, 50.0, 40),
    ("d128-group8-s651", 1, 651, 16, 2, 128, 0.0, 0),
    ("d64-group5-window", 2, 333, 10, 2, 64, 0.0, 100),
    ("d256-cap-window-s517", 1, 517, 4, 2, 256, 50.0, 200),
]
# a bf16 gradient row's largest value is floored at this share of the
# tensor's: the first query's dq is zero in exact arithmetic, and both
# versions return rounding noise there
GRAD_ROW_FLOOR = 1e-3


def grad_close(got, want, dtype):
    if dtype == torch.float32:
        close(got.float().cpu().numpy(), want.float().cpu().numpy(),
              ATOL_FP32)
        return
    got = got.float().cpu().numpy()
    want = want.float().cpu().numpy()
    d = got.shape[-1]
    err = np.abs(got - want).reshape(-1, d).max(-1)
    row_max = np.maximum(np.abs(want).reshape(-1, d).max(-1),
                         GRAD_ROW_FLOOR * np.abs(want).max())
    assert np.isfinite(got).all()
    assert (err / row_max).max() <= ROW_RTOL_BF16


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name,B,S,Hq,Hkv,D,cap,win", BWD_CASES,
                         ids=[c[0] for c in BWD_CASES])
def test_flash_attention_bwd_kernel_matches_plain(cuda, dtype, name, B, S,
                                                  Hq, Hkv, D, cap, win):
    """The backward kernels against ``ref.flash_attention_bwd_plain`` on
    the same q, k, v, out, lse and dO; the forward's lse against the plain
    scores' logsumexp within 1e-4; twice on the same inputs, bit-equal."""
    q, k, v = (t.to(dtype) for t in to_torch(
        *flash_inputs(21, B, S, S, Hq, Hkv, D), device=cuda))
    dout = torch.from_numpy(np.random.RandomState(22).randn(
        B, S, Hq, D).astype(np.float32)).to(cuda, dtype)
    out, lse = tfa.flash_attention(q, k, v, softcap=cap, window=win,
                                   with_lse=True)
    before = tfab.flash_attention_bwd.counter["launches"]
    got = tfab.flash_attention_bwd(q, k, v, out, dout, lse, softcap=cap,
                                   window=win)
    again = tfab.flash_attention_bwd(q, k, v, out, dout, lse, softcap=cap,
                                     window=win)
    torch.cuda.synchronize()
    assert tfab.flash_attention_bwd.counter["launches"] == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    close(lse.cpu().numpy(), ref.flash_attention_lse_ref(
        q, k, softcap=cap, window=win).cpu().numpy(), 1e-4)
    want = ref.flash_attention_bwd_plain(q, k, v, out, dout, lse, True, cap,
                                         win)
    for g, w in zip(got, want):
        assert g.dtype == dtype
        grad_close(g, w, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("name,B,S,Hq,Hkv,D,cap,win", BWD_CASES[4:],
                         ids=[c[0] for c in BWD_CASES[4:]])
def test_flash_attention_bwd_sums_heads_in_a_fixed_order(cuda, name, B, S,
                                                         Hq, Hkv, D, cap,
                                                         win):
    """bf16: dK and dV, summed over each group's query heads by a cluster
    of CTAs in rank order, come out bit-equal on every call, also with
    other launches between the calls."""
    q, k, v = (t.to(torch.bfloat16) for t in to_torch(
        *flash_inputs(24, B, S, S, Hq, Hkv, D), device=cuda))
    dout = torch.from_numpy(np.random.RandomState(25).randn(
        B, S, Hq, D).astype(np.float32)).to(cuda, torch.bfloat16)
    out, lse = tfa.flash_attention(q, k, v, softcap=cap, window=win,
                                   with_lse=True)
    first = tfab.flash_attention_bwd(q, k, v, out, dout, lse, softcap=cap,
                                     window=win)
    for i in range(3):
        tfa.flash_attention(*(t[:, :S - 7 * i].contiguous()
                              for t in (q, k, v)))
        again = tfab.flash_attention_bwd(q, k, v, out, dout, lse,
                                         softcap=cap, window=win)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.gpu
def test_ops_flash_attention_grad_runs_the_backward_kernel(cuda):
    """On CUDA tensors that require grad, ``ops.flash_attention``'s
    backward is the kernel: one launch, the plain version's gradient; a
    strided dO is made contiguous before the launch."""
    from repro_torch.kernels import ops
    q, k, v = to_torch(*flash_inputs(23, 2, 50, 50, 4, 2, 64), device=cuda)
    live = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = ops.flash_attention(*live, window=20)
    dout = torch.randn(2, 4, 50, 64, device=cuda).transpose(1, 2)
    before = tfab.flash_attention_bwd.counter["launches"]
    out.backward(dout)
    torch.cuda.synchronize()
    assert tfab.flash_attention_bwd.counter["launches"] == before + 1
    lse = ref.flash_attention_lse_ref(q, k, window=20)
    want = ref.flash_attention_bwd_plain(q, k, v, out.detach(),
                                         dout.contiguous(), lse, True, 0.0,
                                         20)
    for t, w in zip(live, want):
        grad_close(t.grad, w, torch.float32)


# B4's backward on phase 3's cases (``chip_smoke.SSD_CASES``, one table for
# both) and this file's Q = 1 case; ragged-n13 with every input (dy and dS
# too) off a 16-byte boundary
SSD_BWD_CASES = _chip_smoke().SSD_CASES + [c for c in SSD_CASES
                                           if c[0] == "q1"]


def ssd_bwd_inputs(seed, B, Nc, Q, H, P, N, G, device):
    """x, dt, A, B, C as ``ssd_inputs`` and the cotangents dy, dS."""
    r = np.random.RandomState(seed + 1)
    dy = r.randn(B, Nc, Q, H, P).astype(np.float32)
    dS = r.randn(B, Nc, H, P, N).astype(np.float32)
    return to_torch(*ssd_inputs(seed, B, Nc, Q, H, P, N, G), dy, dS,
                    device=device)


def ssd_bwd_close(got, want):
    """dx rows [P] and dB, dC rows [N] within ROW_RTOL_SSD of their own
    row's largest |value|; ddt and dA within it of their tensor's (dcs is
    a difference of two sums and cancels within a row)."""
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC"), got, want):
        assert g.dtype == torch.float32, name
        if name in ("ddt", "dA"):
            # (dA is exactly zero at Q = 1: dcs cancels)
            err = (g.double() - w).abs().max() / w.abs().max().clamp_min(
                1e-30)
            assert torch.isfinite(g).all() and err <= ROW_RTOL_SSD, name
        else:
            assert row_rel_err(g, w) <= ROW_RTOL_SSD, name


def ssd_bwd_want(args):
    """The plain backward in float64 on the same inputs."""
    return ref.ssd_chunk_bwd_plain(*(t.double() for t in args))


@pytest.mark.gpu
@pytest.mark.parametrize("name,B,Nc,Q,H,P,N,G", SSD_BWD_CASES,
                         ids=[c[0] for c in SSD_BWD_CASES])
def test_ssd_chunk_bwd_kernel_matches_plain(cuda, name, B, Nc, Q, H, P, N,
                                            G):
    """The backward kernels against ``ref.ssd_chunk_bwd_plain`` on the
    same x, dt, A, B, C, dy and dS; one wrapper call, one count."""
    args = ssd_bwd_inputs(31, B, Nc, Q, H, P, N, G, cuda)
    if name == "ragged-n13":
        args = [unaligned(t) for t in args]
    before = tssb.ssd_chunk_bwd.counter["launches"]
    got = tssb.ssd_chunk_bwd(*args)
    torch.cuda.synchronize()
    assert tssb.ssd_chunk_bwd.counter["launches"] == before + 1
    ssd_bwd_close(got, ssd_bwd_want(args))


@pytest.mark.gpu
@pytest.mark.parametrize("name,B,Nc,Q,H,P,N,G", [
    ("mamba2", 2, 4, 256, 32, 64, 128, 1),
    ("groups2-ragged", 1, 3, 100, 8, 32, 16, 2),
], ids=["mamba2", "groups2-ragged"])
def test_ssd_chunk_bwd_kernel_repeats_to_the_bit(cuda, name, B, Nc, Q, H, P,
                                                 N, G):
    """No atomics: two calls on the same inputs give the same bits (dA and
    the group sums of dB and dC included)."""
    args = ssd_bwd_inputs(32, B, Nc, Q, H, P, N, G, cuda)
    got = tssb.ssd_chunk_bwd(*args)
    again = tssb.ssd_chunk_bwd(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.gpu
@pytest.mark.parametrize("Q,H,P,N,n", [
    (256, 25, 64, 16, 203),     # hymba
    (256, 32, 64, 128, 77),     # mamba2
    (100, 4, 32, 16, 9),
], ids=["hymba", "mamba2", "ragged-q"])
def test_ssd_chunk_bwd_rows_do_not_depend_on_earlier_dy(cuda, Q, H, P, N,
                                                        n):
    """dy changed in rows < n leaves rows >= n of dx, ddt, dB and dC
    bit-equal: each sum over t >= s is a true suffix sum, never a total
    less a prefix."""
    args = ssd_bwd_inputs(33, 1, 1, Q, H, P, N, 1, cuda)
    moved = list(args)
    moved[5] = args[5].clone()
    moved[5][:, :, :n] = torch.randn_like(moved[5][:, :, :n])
    got = tssb.ssd_chunk_bwd(*args)
    again = tssb.ssd_chunk_bwd(*moved)
    for i in (0, 1, 3, 4):
        assert torch.equal(got[i][:, :, n:], again[i][:, :, n:]), i


@pytest.mark.gpu
def test_ops_ssd_chunk_grad_runs_the_backward_kernel(cuda):
    """On CUDA tensors that require grad, ``ops.ssd_chunk``'s backward is
    the kernel: one launch, the plain version's gradient, with a strided
    dy made contiguous and the unused S's gradient arriving as zeros."""
    from repro_torch.kernels import ops
    args = ssd_bwd_inputs(34, 1, 2, 100, 4, 32, 16, 1, cuda)
    live = [t.clone().requires_grad_(True) for t in args[:5]]
    y, _ = ops.ssd_chunk(*live)
    dy = args[5].transpose(-1, -2).contiguous().transpose(-1, -2)
    before = tssb.ssd_chunk_bwd.counter["launches"]
    y.backward(dy)
    torch.cuda.synchronize()
    assert tssb.ssd_chunk_bwd.counter["launches"] == before + 1
    ssd_bwd_close([t.grad for t in live],
                  ssd_bwd_want(args[:5] + [dy.contiguous(),
                                           torch.zeros_like(args[6])]))


@pytest.mark.gpu
def test_mamba2_train_step_on_the_card_equals_the_cpu(cuda, no_tf32):
    """A mamba2 smoke train step (fp32, remat, 2 microbatches, a padded
    last chunk) on the card, through B4 and its backward, gives the CPU's
    loss within a relative 1e-5 and its parameters within 1e-5."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.pipeline import DataConfig, packed_batches
    from repro_torch.kernels import ops
    from repro_torch.train.optimizer import tree_leaves, tree_map
    from repro_torch.train.trainer import (TrainConfig, batch_to_device,
                                           init_train_state,
                                           make_train_step)
    cfg = get_smoke_config("mamba2-370m")
    tcfg = TrainConfig(microbatches=2, compute_dtype=torch.float32)
    batch = next(packed_batches(DataConfig(vocab_size=cfg.vocab_size,
                                           seq_len=96, batch_size=4)))
    # one set of weights: a generator on the card draws other numbers
    cpu = init_train_state(cfg, 0, tcfg, "cpu")
    card = tree_map(lambda t: t.to(cuda), cpu)
    cpu, m_cpu = make_train_step(cfg, tcfg)(cpu, batch_to_device(batch,
                                                                 "cpu"))
    ops.reset_launch_counts()
    card, m_card = make_train_step(cfg, tcfg)(card, batch_to_device(batch,
                                                                    cuda))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["ssd_chunk_bwd"] == cfg.n_layers * 2
    assert counts["ssd_chunk"] == cfg.n_layers * 2 * 2
    np.testing.assert_allclose(float(m_card["nll"]), float(m_cpu["nll"]),
                               rtol=1e-5)
    for a, b in zip(tree_leaves(card["params"]), tree_leaves(cpu["params"])):
        close(a.detach().cpu().numpy(), b.numpy(), 1e-5)


# --------------------------------------------------------------------------
# The compiled step on the card (``serving.graphs``): B2's device-offset
# form, kernels replayed from a captured graph, a graphed engine.
# --------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name,B,C,off,Hq,Hkv,D,cap,win", CHUNK_CASES,
                         ids=CHUNK_IDS)
def test_flash_attention_device_offset_is_bit_equal(cuda, dtype, name, B, C,
                                                    off, Hq, Hkv, D, cap,
                                                    win):
    """The offset as an int32 device scalar, one per row, and per-row
    offsets that differ: each bit-equal to the by-value form.  The kernel
    counts each launch, and in ``offset_launches`` those whose offset it
    read is > 0, as for the by-value form."""
    q, k, v = (t.to(dtype) for t in to_torch(
        *flash_inputs(19, B, C, off + C, Hq, Hkv, D), device=cuda))
    kw = dict(softcap=cap, window=win)
    want = tfa.flash_attention(q, k, v, q_offset=off, **kw)
    before = tfa.flash_attention.counter.read()
    for t in (torch.tensor(off, dtype=torch.int32, device=cuda),
              torch.full((B,), off, dtype=torch.int32, device=cuda)):
        assert torch.equal(tfa.flash_attention(q, k, v, q_offset=t, **kw),
                           want)
    assert tfa.flash_attention.counter.read() == {
        "launches": before["launches"] + 2,
        "offset_launches": before["offset_launches"] + 2 * (off > 0)}
    offs = [off - 7 * b for b in range(B)]
    got = tfa.flash_attention(q, k, v, q_offset=torch.tensor(
        offs, dtype=torch.int32, device=cuda), **kw)
    for b in range(B):
        assert torch.equal(got[b:b + 1], tfa.flash_attention(
            q[b:b + 1], k[b:b + 1], v[b:b + 1], q_offset=offs[b], **kw))


@pytest.mark.gpu
def test_captured_kernels_replay_their_eager_calls(cuda):
    """B1 and B2 (device offset) captured in one CUDA graph, replayed on
    new inputs copied into the static buffers: bit-equal to eager calls on
    those inputs.  The capture counts no launch; each replay counts B1's
    and B2's, and B2's offset launch where the offset written before it is
    > 0."""
    from repro_torch.kernels import ops
    scale = 1.0 / 32 ** 0.5
    paged = [t.to(cuda) for t in to_torch(*paged_inputs(
        23, 3, 4, 2, 32, 8, [5, 17, 40]))]
    paged[:3] = [t.to(torch.bfloat16) for t in paged[:3]]
    q, kp, vp, table, lens, start = paged
    fq, fk, fv = (t.to(torch.bfloat16) for t in to_torch(
        *flash_inputs(24, 1, 24, 64, 4, 2, 32), device=cuda))
    off = torch.tensor(40, dtype=torch.int32, device=cuda)

    def calls():
        return (tfd.paged_decode(q, kp, vp, table, lens, start, 0.0, scale),
                tfa.flash_attention(fq, fk, fv, q_offset=off))

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        calls()
    torch.cuda.current_stream().wait_stream(side)
    keys = ("paged_decode", "flash_attention", "flash_attention_offset")

    def counts():
        c = ops.launch_counts()
        return [c[k] for k in keys]

    before = counts()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = calls()
    assert counts() == before
    gen = torch.Generator(device=cuda)
    gen.manual_seed(1)
    for new_off in (40, 13, 0):
        q.copy_(torch.randn(q.shape, generator=gen, device=cuda))
        fq.copy_(torch.randn(fq.shape, generator=gen, device=cuda))
        lens.copy_(torch.randint(1, 41, lens.shape, generator=gen,
                                 device=cuda, dtype=torch.int32))
        off.fill_(new_off)
        was = counts()
        graph.replay()
        assert counts() == [was[0] + 1, was[1] + 1, was[2] + (new_off > 0)]
        for got, want in zip(outs, calls()):
            assert torch.equal(got, want), new_off


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["yi-9b", "hymba-1.5b", "olmoe-1b-7b"])
def test_graphed_engine_equals_eager_on_the_card(cuda, arch):
    """A smoke engine in bf16 (paged at horizon 4, 16-token chunks, which
    the SSM model ignores): the graphed engine's streams, decode_syncs and
    B1, B2 (and offset) and B4 launches equal the eager engine's on three
    passes, and the warm third captures nothing."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import ops
    from repro_torch.models import init_params
    from repro_torch.serving.engine import ServingEngine
    cs = _chip_smoke()
    cfg = get_smoke_config(arch)
    params = init_params(cfg, seed=0, dtype=torch.bfloat16, device=cuda)
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32)
               for n in (9, 40, 23, 61, 17)]
    kw = dict(num_blocks=128, block_size=8, max_seqs=4, decode_horizon=4,
              prefill_chunk_tokens=16, dtype=torch.bfloat16)
    runs = []
    for graphs in (False, True):
        eng = ServingEngine(cfg, params, device=cuda, graphs=graphs, **kw)
        for rid0 in (0, 100, 200):
            ops.reset_launch_counts()
            captures = eng.graph_captures
            fin, _ = cs.serve_on(eng, prompts, 12, rid0=rid0)
            eng._chunk_rr = 0
            runs.append(({r: fin[r].generated for r in fin},
                         cs.graph_counts(ops), eng.graph_captures - captures))
    (eager, counts, _), = runs[:1]
    for got, got_counts, _ in runs[1:]:
        assert got == eager and got_counts == counts
    # cold: the decode and chunk keys; second pass: the prefill keys the
    # cold one ran eagerly; warm: nothing
    built = [n for _, _, n in runs[3:]]
    assert built[0] > 0 and built[2] == 0
    assert built[1] == eng._steps.built["prefill"]


@pytest.mark.gpu
def test_captured_capacity_prefill_replays_its_eager_run(cuda):
    """An olmoe smoke group of two 1100-token prompts (2200 tokens, past
    ``moe.DENSE_TOKENS``: the capacity dispatch) as the prefill step
    ("prefill", 2, 1100): the cold call (eager), the second (eager on the
    static buffers, then captured) and a replay, each on other slots and
    pages, write the eager engine's K/V to the bit and give its first
    tokens and streams."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params, moe
    from repro_torch.serving.engine import ServingEngine
    cfg = get_smoke_config("olmoe-1b-7b")
    params = init_params(cfg, seed=0, dtype=torch.bfloat16, device=cuda)
    rng = np.random.RandomState(8)
    prompts = [rng.randint(0, cfg.vocab_size, 1100).astype(np.int32)
               for _ in range(2)]
    assert 2 * 1100 > moe.DENSE_TOKENS
    kw = dict(num_blocks=320, block_size=16, max_seqs=4,
              max_blocks_per_seq=80, decode_horizon=2, dtype=torch.bfloat16)
    runs = {}
    for graphs in (False, True):
        eng = ServingEngine(cfg, params, device=cuda, graphs=graphs, **kw)
        for n, rid0 in enumerate((0, 10, 20)):
            if n:
                # a later pass takes other slots and pages
                eng.submit(90 + n, prompts[0][:40 + n], 2)
                eng.step()
            for i, p in enumerate(prompts):
                eng.submit(rid0 + i, p, 5)
            eng.step()
            pages = [eng.cache.k[:, eng.cache.seq_blocks[r.slot]].clone()
                     for r in sorted(eng.active.values(),
                                     key=lambda r: r.rid) if r.rid >= rid0]
            fin = {r.rid - rid0: r.generated
                   for r in eng.run_to_completion() if r.rid < 90}
            runs[graphs, n] = (pages, fin)
        if graphs:
            assert ("prefill", 2, 1100) in eng._steps.entries
            assert eng._steps.replayed["prefill"] >= 1
    for n in (0, 1, 2):
        (want_pages, want), (got_pages, got) = runs[False, n], runs[True, n]
        assert got == want
        for a, b in zip(got_pages, want_pages):
            assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["yi-9b", "hymba-1.5b"])
def test_sampled_graphed_engine_equals_eager_on_the_card(cuda, arch):
    """A sampled smoke engine in bf16 (paged at horizon 4): the graphed
    engine's streams and launches equal the eager engine's on two passes,
    the counter-based sampler's noise made inside the decode graphs from
    the step buffer, and the warm third pass captures nothing."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import ops
    from repro_torch.models import init_params
    from repro_torch.serving.engine import ServingEngine
    cs = _chip_smoke()
    cfg = get_smoke_config(arch)
    params = init_params(cfg, seed=0, dtype=torch.bfloat16, device=cuda)
    rng = np.random.RandomState(4)
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32)
               for n in (9, 40, 23, 61, 17, 9)]
    kw = dict(num_blocks=128, block_size=8, max_seqs=4, decode_horizon=4,
              dtype=torch.bfloat16, greedy=False, seed=5)
    runs = []
    for graphs in (False, True):
        eng = ServingEngine(cfg, params, device=cuda, graphs=graphs, **kw)
        for rid0 in (0, 100, 200):
            ops.reset_launch_counts()
            captures = eng.graph_captures
            fin, _ = cs.serve_on(eng, prompts, 12, rid0=rid0)
            runs.append(({r: fin[r].generated for r in fin},
                         cs.graph_counts(ops), eng.graph_captures - captures))
        assert (len(eng._steps.keys("decode")) > 0) == graphs
    eager, graphed = runs[:3], runs[3:]
    for (want, counts, _), (got, got_counts, _) in zip(eager, graphed):
        assert got == want and got_counts == counts
    assert graphed[0][2] > 0 and graphed[2][2] == 0
    eng = ServingEngine(cfg, params, device=cuda, **dict(kw, greedy=True))
    fin, _ = cs.serve_on(eng, prompts, 12)
    greedy = {r: fin[r].generated for r in fin}
    assert greedy != eager[0][0]


@pytest.mark.gpu
def test_counter_hash_on_the_card_equals_the_cpu(cuda):
    """The sampler's integer hash gives the CPU's bits on the card: its
    32-bit multiply and finaliser over [0, 2^32), the top included, and
    ``step_hash`` of several (seed, step) at a decode batch's shape; the
    Gumbel noise made from it agrees within float rounding."""
    from repro_torch.models import sampling
    rng = np.random.RandomState(2)
    xs = torch.from_numpy(np.concatenate([
        rng.randint(0, 2 ** 32, 1 << 16, dtype=np.int64),
        [0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1]]))
    assert torch.equal(sampling._fmix32(xs.to(cuda)).cpu(),
                       sampling._fmix32(xs))
    for c in (0x85EBCA6B, 0xC2B2AE35, 0x9E3779B9, 0x7FEB352D):
        assert torch.equal(sampling._mul32(xs.to(cuda), c).cpu(),
                           sampling._mul32(xs, c))
    for seed, step in ((0, 0), (5, 1234), (2 ** 40 + 7, 2 ** 32 + 3)):
        t = torch.tensor(step, dtype=torch.int64)
        assert torch.equal(sampling.step_hash(seed, t.to(cuda), 8, 4096)
                           .cpu(), sampling.step_hash(seed, t, 8, 4096))
        torch.testing.assert_close(
            sampling.step_noise(seed, t.to(cuda), 8, 4096).cpu(),
            sampling.step_noise(seed, t, 8, 4096), rtol=1e-6, atol=1e-5)
