"""The dense decode kernel's split over positions, on the CPU.

``ref.flash_decode_split_plain`` computes what the split kernel computes:
each row's live 32-position tiles are dealt out over ``n_split`` splits
(``ref.split_ranges``), each split keeps an fp32 partial (m, l, acc) and
a combine step rescales and sums them.  It is held against the unsplit
plain version and against the JAX package's oracle and its
interpret-mode Pallas kernel (lens >= 1, as ``tests/test_kernels.py``
holds the Pallas kernel; at len == 0 the port writes zeros and JAX the
mean of V).  ``ref.split_ranges`` and ``flash_decode.split_count``, which
picks ``n_split`` for a launch, are tested on their own.  Inputs are made with numpy from a seed;
everything is fp32 and agrees to ATOL = 1e-5 (the same function summed in
another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_kernels_gpu import close, dense_inputs, split_inputs, to_torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import flash_decode as tfd
from repro_torch.kernels import ref

ATOL = 1e-5
TILE = 32
H100_SMS = 132

# name, B, S, Hq, Hkv, D, lens, starts: groups 1, 5 and 8, S on and off
# the tile, len 0 and 1, a start inside a tile and one past whole splits
SPLIT_PLAIN_CASES = [
    ("group1", 2, 300, 4, 4, 32, [300, 45], [0, 7]),
    ("group5-ragged-s", 2, 130, 10, 2, 64, [130, 77], [0, 0]),
    ("group8", 3, 200, 16, 2, 32, [1, 200, 99], [0, 150, 33]),
    ("start-past-splits", 2, 640, 8, 4, 64, [640, 600], [500, 577]),
    ("len0", 3, 96, 4, 2, 32, [0, 96, 50], [0, 0, 10]),
]
SPLIT_PLAIN_IDS = [c[0] for c in SPLIT_PLAIN_CASES]


def _tiles(S):
    return -(-S // TILE)


@pytest.mark.parametrize("n_split", ["1", "2", "5", "more"])
@pytest.mark.parametrize("name,B,S,Hq,Hkv,D,lens,starts", SPLIT_PLAIN_CASES,
                         ids=SPLIT_PLAIN_IDS)
def test_split_plain_matches_unsplit_plain(name, B, S, Hq, Hkv, D, lens,
                                           starts, n_split):
    n = _tiles(S) + 3 if n_split == "more" else int(n_split)
    args = to_torch(*split_inputs(30, B, S, Hq, Hkv, D, lens, starts))
    for cap in (0.0, 30.0):
        got = ref.flash_decode_split_plain(*args, cap, 1.0 / D ** 0.5, n)
        want = ref.flash_decode_plain(*args, cap, 1.0 / D ** 0.5)
        close(got.numpy(), want.numpy(), ATOL)


@pytest.mark.parametrize("n_split", [1, 2, 5, 40])
@pytest.mark.parametrize("B,S,Hq,Hkv,D", [
    (2, 256, 4, 4, 64),     # group 1
    (2, 100, 25, 5, 64),    # group 5, ragged S
    (1, 128, 8, 1, 128),    # group 8
])
def test_split_plain_matches_jax_kernel(B, S, Hq, Hkv, D, n_split):
    """start = 0, lens >= 1: the JAX oracle and the interpret-mode Pallas
    kernel through its padding entry."""
    r = np.random.RandomState(31)
    q, k, v, _, start = dense_inputs(31, B, S, Hq, Hkv, D, [S] * B)
    lens = r.randint(1, S + 1, B).astype(np.int32)
    got = ref.flash_decode_split_plain(*to_torch(q, k, v, lens, start), 30.0,
                                       1.0 / D ** 0.5, n_split).numpy()
    jq, jk, jv, jl = map(jnp.asarray, (q, k, v, lens))
    close(got, jref.flash_decode_ref(jq, jk, jv, jl, softcap=30.0), ATOL)
    close(got, jops.flash_decode(jq, jk, jv, jl, softcap=30.0,
                                 interpret=True), ATOL)


@pytest.mark.parametrize("n_split", [2, 5, 63])
@pytest.mark.parametrize("name,B,S,Hq,Hkv,D,lens,starts",
                         [c for c in SPLIT_PLAIN_CASES if 0 not in c[6]],
                         ids=[c[0] for c in SPLIT_PLAIN_CASES
                              if 0 not in c[6]])
def test_split_plain_start_matches_jax_oracle(name, B, S, Hq, Hkv, D, lens,
                                              starts, n_split):
    """With a per-sequence start (gemma2's window; the Pallas kernel has
    none): held against the oracle."""
    q, k, v, ln, st = split_inputs(32, B, S, Hq, Hkv, D, lens, starts)
    got = ref.flash_decode_split_plain(*to_torch(q, k, v, ln, st), 50.0,
                                       1.0 / D ** 0.5, n_split).numpy()
    want = jref.flash_decode_ref(*map(jnp.asarray, (q, k, v, ln)),
                                 softcap=50.0, start=jnp.asarray(st))
    close(got, want, ATOL)


def test_split_plain_len0_is_zero_and_other_rows_match_jax():
    q, k, v, ln, st = split_inputs(33, 3, 96, 8, 2, 32, [0, 96, 50],
                                   [0, 0, 10])
    got = ref.flash_decode_split_plain(*to_torch(q, k, v, ln, st), 0.0,
                                       1.0 / 32 ** 0.5, 3).numpy()
    assert not got[0].any()
    want = jref.flash_decode_ref(*map(jnp.asarray, (q, k, v, ln)),
                                 start=jnp.asarray(st))
    close(got[1:], np.asarray(want)[1:], ATOL)


def test_split_plain_with_empty_splits():
    """A late start and a short len leave fewer live tiles than splits,
    so some splits have nothing to attend (m = -inf, l = 0); they drop out
    of the combine."""
    S, n_split = 640, 10                 # 20 tiles
    lens, starts = [640, 200], [500, 0]  # 5 and 7 live tiles
    args = to_torch(*split_inputs(34, 2, S, 8, 2, 64, lens, starts))
    lo, hi = ref.split_ranges(args[3], args[4], S, n_split)
    attended = (torch.minimum(hi, args[3][:, None].long())
                > torch.maximum(lo, args[4][:, None].long())).sum(1)
    assert attended.tolist() == [5, 7]
    got = ref.flash_decode_split_plain(*args, 0.0, 1.0 / 8, n_split)
    want = ref.flash_decode_plain(*args, 0.0, 1.0 / 8)
    close(got.numpy(), want.numpy(), ATOL)
    assert torch.isfinite(got).all()


# name, S, n_split, lens, starts: ragged lengths, a window deep in the
# cache, len 0 and 1, fewer live tiles than splits, a start past the len
SPLIT_RANGE_CASES = [
    ("dense-run", 979, 8, [336, 512, 700, 979, 963, 480, 820, 640],
     [0] * 8),
    ("window", 4000, 31, [4000, 3001, 2048], [3000, 2001, 1987]),
    ("short-rows", 640, 10, [0, 1, 33, 200, 640], [0, 0, 0, 150, 600]),
    ("start-past-len", 300, 4, [100, 300], [200, 299]),
]


@pytest.mark.parametrize("name,S,n_split,lens,starts", SPLIT_RANGE_CASES,
                         ids=[c[0] for c in SPLIT_RANGE_CASES])
def test_split_ranges_deal_each_rows_live_tiles_evenly(name, S, n_split,
                                                      lens, starts):
    """Each row's live tiles, from the tile holding start to the one
    holding min(len, S) - 1, in consecutive ranges whose sizes differ by
    at most one tile; empty ranges only where the row has fewer live tiles
    than splits."""
    lo, hi = ref.split_ranges(torch.tensor(lens, dtype=torch.int32),
                              torch.tensor(starts, dtype=torch.int32), S,
                              n_split)
    assert lo.shape == hi.shape == (len(lens), n_split)
    for b, (ln, st) in enumerate(zip(lens, starts)):
        limit = min(ln, S)
        live_end = _tiles(limit)
        first = min(st // TILE, live_end)
        n_live = live_end - first
        lo_b, hi_b = lo[b].tolist(), hi[b].tolist()
        assert lo_b[0] == first * TILE and hi_b[-1] == live_end * TILE
        assert lo_b[1:] == hi_b[:-1]
        sizes = [(h - l) // TILE for l, h in zip(lo_b, hi_b)]
        assert all(l % TILE == 0 and h >= l for l, h in zip(lo_b, hi_b))
        assert max(sizes) - min(sizes) <= 1
        assert sum(s > 0 for s in sizes) == min(n_split, n_live)


def test_split_ranges_keep_every_split_busy_at_the_dense_run_shape():
    """At the dense run's shape (8 splits, lens 336-979) even the shortest
    row's 11 live tiles reach all 8 splits, and no split takes more than
    the longest row's share of 4 tiles."""
    lens = torch.tensor([336, 512, 700, 979, 963, 480, 820, 640],
                        dtype=torch.int32)
    lo, hi = ref.split_ranges(lens, torch.zeros_like(lens), 979, 8)
    tiles = (hi - lo) // TILE
    assert (tiles > 0).all()
    assert tiles.max().item() == 4


def test_split_plain_keeps_the_dtype():
    q, k, v, ln, st = to_torch(*split_inputs(35, 2, 70, 8, 2, 32, [70, 3],
                                             [0, 0]))
    bf = [t.to(torch.bfloat16) for t in (q, k, v)]
    got = ref.flash_decode_split_plain(*bf, ln, st, 0.0, 1.0 / 32 ** 0.5, 3)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape


# --------------------------------------------------------------------------
# split_count
# --------------------------------------------------------------------------


def test_split_count_at_the_dense_run_shape():
    """B = 8, Hkv = 4 and the longest of the phase-5 contexts: about 8
    splits of 4 tiles, 256 CTAs on 132 SMs."""
    n = tfd.split_count(8, 4, 979, TILE, H100_SMS)
    assert n == 8
    assert 8 * 4 * n >= H100_SMS


@pytest.mark.parametrize("B,Hkv", [(66, 4), (264, 1), (33, 8), (100, 8)])
def test_split_count_is_one_once_the_batch_fills_the_card(B, Hkv):
    assert B * Hkv >= 2 * H100_SMS
    assert tfd.split_count(B, Hkv, 4096, TILE, H100_SMS) == 1


@pytest.mark.parametrize("max_len", [1, 31, 32, 33, 100])
def test_split_count_never_exceeds_the_live_tiles(max_len):
    n = tfd.split_count(1, 1, max_len, TILE, H100_SMS)
    assert 1 <= n <= _tiles(max_len)
    assert n == _tiles(max_len)      # one CTA wants every tile it can get


def test_split_count_sweep():
    """Over a grid of shapes: at least 1, at most the live tiles, every SM
    busy where the tiles allow, and no split left empty by the rounding of
    tiles per split."""
    for B in (1, 2, 3, 8, 16, 33, 64):
        for Hkv in (1, 2, 4, 5, 8):
            for max_len in (1, 17, 64, 300, 979, 2048, 8192):
                for tile in (16, 32):
                    n = tfd.split_count(B, Hkv, max_len, tile, H100_SMS)
                    tiles = -(-max_len // tile)
                    assert 1 <= n <= tiles
                    if B * Hkv >= 2 * H100_SMS:
                        assert n == 1
                    per = -(-tiles // n)
                    assert (n - 1) * per < tiles    # the last split has work
                    if n < tiles:
                        # fewer splits than tiles only once the CTAs fill
                        # every SM
                        assert B * Hkv * n >= H100_SMS


def test_flash_decode_wrapper_refuses_cpu_tensors():
    args = to_torch(*split_inputs(36, 2, 40, 4, 2, 32, [40, 9], [0, 0]))
    with pytest.raises(ValueError, match="CUDA kernel"):
        tfd.flash_decode(*args, 0.0, 1.0)


def test_fixed_split_entry_refuses_cpu_tensors_and_counts_nothing():
    args = to_torch(*split_inputs(37, 2, 40, 4, 2, 32, [40, 9], [0, 0]))
    before = tfd.flash_decode.launches
    with pytest.raises(ValueError, match="CUDA kernel"):
        tfd._launch(*args, 0.0, 1.0, 2)
    assert tfd.flash_decode.launches == before
