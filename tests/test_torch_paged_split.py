"""The paged decode kernel's split over pages, on the CPU.

``ref.paged_decode_split_plain`` computes what the split paged kernel
computes: the pages are gathered into a dense cache, each row's live pages
(from the page that holds ``start`` to the one that holds ``len - 1``) are
dealt out over ``n_split`` splits, each split keeps an fp32 partial (m, l,
acc) and a combine step rescales and sums them.  It is held against the
unsplit plain version and against the JAX package's interpret-mode Pallas
paged kernel (``flash_decode_paged_native``), with a window, trash-page
rows and rows of 1, 15, 16 and 17 tokens; at ``len == 0`` the row is zero,
as the Pallas kernel gives.  ``flash_decode.split_count`` is held to the
split counts the served shapes get.  Inputs are made with numpy from a
seed; everything is fp32 and agrees to ATOL = 3e-5 (the same function
summed in another order), as ``tests/test_torch_kernels.py`` holds the
unsplit plain version.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_kernels_gpu import close, paged_inputs, to_torch

from repro.kernels import flash_decode as jfd
from repro_torch.kernels import flash_decode as tfd
from repro_torch.kernels import ref

ATOL = 3e-5
H100_SMS = 132

# name, B, Hq, Hkv, D, page, lens, softcap, window, trash rows: rows of 1,
# 15, 16 and 17 tokens on 16-token pages, a window that starts mid-page,
# trash-page rows, groups 1, 2, 5 and 8
PAGED_SPLIT_CASES = [
    ("rows-1-15-16-17", 4, 8, 2, 32, 16, [1, 15, 16, 17], 0.0, 0, ()),
    ("window-mid-page", 3, 4, 2, 32, 8, [10, 37, 64], 30.0, 12, ()),
    ("trash-rows", 4, 4, 4, 32, 8, [9, 1, 30, 17], 0.0, 0, (1, 3)),
    ("hymba-group5", 2, 25, 5, 64, 16, [20, 77], 0.0, 0, ()),
    ("long-window-group8", 2, 8, 1, 64, 16, [300, 161], 50.0, 70, (1,)),
]
PAGED_SPLIT_IDS = [c[0] for c in PAGED_SPLIT_CASES]
_BY_NAME = {c[0]: c for c in PAGED_SPLIT_CASES}


def _inputs(name):
    _, B, Hq, Hkv, D, page, lens, _, win, trash = _BY_NAME[name]
    return paged_inputs(41, B, Hq, Hkv, D, page, lens, window=win,
                        trash_rows=trash)


@functools.lru_cache(maxsize=None)
def _pallas(name):
    """The interpret-mode Pallas paged kernel on case ``name`` (once per
    case: every split count is held against the same result)."""
    cap = _BY_NAME[name][7]
    q, kp, vp, tb, ln, st = _inputs(name)
    return np.asarray(jfd.flash_decode_paged_native(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tb),
        jnp.asarray(ln), start=jnp.asarray(st), softcap=cap,
        interpret=True))


def _split(name, n_split):
    D, cap = _BY_NAME[name][4], _BY_NAME[name][7]
    args = to_torch(*_inputs(name))
    return (ref.paged_decode_split_plain(*args, cap, 1.0 / D ** 0.5,
                                         n_split),
            ref.paged_decode_plain(*args, cap, 1.0 / D ** 0.5))


def _n_split(name, n_split):
    """The split count a case id names; "more" is more splits than the
    table has pages, so some are empty."""
    if n_split != "more":
        return int(n_split)
    _, B, _, _, _, page, lens, *_ = _BY_NAME[name]
    return -(-max(lens) // page) + 3


@pytest.mark.parametrize("n_split", ["1", "2", "5", "more"])
@pytest.mark.parametrize("name", PAGED_SPLIT_IDS)
def test_paged_split_plain_matches_jax_kernel(name, n_split):
    got, _ = _split(name, _n_split(name, n_split))
    close(got.numpy(), _pallas(name), ATOL)


@pytest.mark.parametrize("n_split", ["1", "2", "5", "more"])
@pytest.mark.parametrize("name", PAGED_SPLIT_IDS)
def test_paged_split_plain_matches_unsplit_plain(name, n_split):
    got, want = _split(name, _n_split(name, n_split))
    close(got.numpy(), want.numpy(), ATOL)
    assert torch.isfinite(got).all()


@pytest.mark.parametrize("n_split", [1, 3, 9])
def test_paged_split_plain_len0_is_zero(n_split):
    """The len == 0 row gives zeros, as the Pallas kernel does; the other
    rows match the interpret-mode kernel."""
    q, kp, vp, tb, ln, st = paged_inputs(42, 3, 8, 2, 32, 16, [0, 40, 17],
                                         window=20)
    got = ref.paged_decode_split_plain(*to_torch(q, kp, vp, tb, ln, st), 0.0,
                                       1.0 / 32 ** 0.5, n_split).numpy()
    assert not got[0].any()
    kernel = jfd.flash_decode_paged_native(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tb),
        jnp.asarray(ln), start=jnp.asarray(st), interpret=True)
    close(got, kernel, ATOL)


def test_paged_split_plain_deals_pages_not_positions():
    """The tile of the split is a page: at 8-token pages a row of 40
    tokens has 5 live pages, so 5 splits each attend exactly one page and
    a sixth is empty (m = -inf, l = 0), and the result still matches."""
    q, kp, vp, tb, ln, st = to_torch(*paged_inputs(43, 1, 4, 2, 32, 8,
                                                   [40]))
    lo, hi = ref.split_ranges(ln, st, tb.shape[1] * 8, 6, tile=8)
    assert ((hi - lo) // 8).tolist() == [[0, 1, 1, 1, 1, 1]]
    got = ref.paged_decode_split_plain(q, kp, vp, tb, ln, st, 0.0, 0.25, 6)
    want = ref.paged_decode_plain(q, kp, vp, tb, ln, st, 0.0, 0.25)
    close(got.numpy(), want.numpy(), ATOL)


def test_paged_split_plain_keeps_the_dtype():
    q, kp, vp, tb, ln, st = to_torch(*paged_inputs(44, 2, 4, 2, 32, 8,
                                                   [19, 3]))
    bf = [t.to(torch.bfloat16) for t in (q, kp, vp)]
    got = ref.paged_decode_split_plain(*bf, tb, ln, st, 0.0, 0.25, 3)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape


# --------------------------------------------------------------------------
# split_count at the paged kernel's shapes (tile = one 16-token page,
# max_len = the block table's width in positions)
# --------------------------------------------------------------------------


def test_split_count_at_the_yi9b_paged_shape():
    """B = 8, Hkv = 4 on a 64-page table: 8 splits, 256 CTAs."""
    n = tfd.split_count(8, 4, 64 * 16, 16, H100_SMS)
    assert n == 8
    assert 8 * 4 * n == 256


def test_split_count_at_the_hymba_paged_shape():
    """B = 8, Hkv = 5 on a 64-page table: 7 splits, 280 CTAs."""
    n = tfd.split_count(8, 5, 64 * 16, 16, H100_SMS)
    assert n == 7
    assert 8 * 5 * n == 280


@pytest.mark.parametrize("B,Hkv", [(66, 4), (264, 1), (53, 5), (33, 8)])
def test_paged_split_count_is_one_once_the_batch_fills_the_card(B, Hkv):
    assert B * Hkv >= 2 * H100_SMS
    assert tfd.split_count(B, Hkv, 128 * 16, 16, H100_SMS) == 1


# --------------------------------------------------------------------------
# The wrappers refuse CPU tensors (ops sends those to the plain version)
# --------------------------------------------------------------------------


def test_paged_decode_wrapper_refuses_cpu_tensors():
    args = to_torch(*paged_inputs(45, 2, 4, 2, 32, 8, [9, 30]))
    with pytest.raises(ValueError, match="CUDA kernel"):
        tfd.paged_decode(*args, 0.0, 1.0)


def test_fixed_paged_split_entry_refuses_cpu_tensors_and_counts_nothing():
    args = to_torch(*paged_inputs(46, 2, 4, 2, 32, 8, [9, 30]))
    before = (tfd.paged_decode.counter["launches"],
              tfd.paged_decode.last_n_split)
    with pytest.raises(ValueError, match="CUDA kernel"):
        tfd._launch_paged(*args, 0.0, 1.0, 2)
    assert (tfd.paged_decode.counter["launches"],
            tfd.paged_decode.last_n_split) == before
