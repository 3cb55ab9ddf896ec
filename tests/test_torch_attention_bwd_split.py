"""The work split of the prefill attention's backward kernels, on the CPU.

``ref.attention_bwd_split`` lists what each CTA of the bf16 launches of
``csrc/flash_attention_bwd.cu`` computes: dK/dV a (KV head, 64-key tile)
at a time, its group's query heads dealt over a cluster of CTAs; dQ a
64-query tile at a time.  Held here against the plain mask: every (query
head, key tile, query step) and (query head, query tile, key step) with a
visible pair is visited once and no other, the visible pairs so visited
are the mask's, and at the train shapes every SM gets a dK/dV CTA and the
longest CTA does under twice the mean.  ``flash_attention_bwd_split_plain``
sums the gradients in the kernels' order (partials a CTA, a cluster's
partials in rank order); it stays within the card test's limits
(``test_torch_kernels_gpu.grad_close``) of ``ref.flash_attention_bwd_plain``,
which ``test_torch_attention_grad.py`` holds against JAX's autodiff.
"""
import collections

import numpy as np
import pytest
import torch
from test_torch_kernels_gpu import grad_close

from repro_torch.kernels import ref

SMS = 132                    # H100 SXM


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the other test workers hold the other cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def visible(Sq, Sk, causal, window):
    q = np.arange(Sq)[:, None]
    k = np.arange(Sk)[None, :]
    ok = np.ones((Sq, Sk), bool)
    if causal:
        ok &= k <= q
    if window > 0:
        ok &= k > q - window
    return ok


# name, B, Sq, Sk, Hq, Hkv, D, causal, window
BOOK_CASES = [
    ("group8-ragged", 1, 651, 651, 16, 2, 128, True, 0),
    ("group5-window", 2, 333, 333, 10, 2, 64, True, 100),
    ("group3-sq-below-sk", 1, 70, 200, 6, 2, 32, True, 0),
    ("d256-window", 1, 517, 517, 4, 2, 256, True, 200),
    ("group12-full", 1, 130, 130, 12, 1, 64, False, 0),
    ("group1-window", 1, 300, 300, 2, 2, 32, False, 50),
]


@pytest.mark.parametrize("name,B,Sq,Sk,Hq,Hkv,D,causal,win", BOOK_CASES,
                         ids=[c[0] for c in BOOK_CASES])
def test_split_visits_every_visible_block_once(name, B, Sq, Sk, Hq, Hkv, D,
                                               causal, win):
    work = ref.attention_bwd_split(B, Sq, Sk, Hq, Hkv, D, causal, win)
    ok = visible(Sq, Sk, causal, win)
    rows, step, group = 64, work["step"], Hq // Hkv
    assert group % work["split"] == 0 and work["split"] <= 8
    # dK/dV: (b, h, key tile, query step), each once, the blocks with a
    # visible pair and their pairs the mask's
    seen = collections.Counter()
    pairs = 0
    for b, hk, k0, rank, steps in work["dkdv"]:
        for h, q0 in steps:
            assert h // group == hk and (h - hk * group) % work["split"] \
                == rank
            seen[(b, h, k0, q0)] += 1
            pairs += ok[q0:q0 + step, k0:k0 + rows].sum()
    want = {(b, h, k0, q0) for b in range(B) for h in range(Hq)
            for k0 in range(0, Sk, rows) for q0 in range(0, Sq, step)
            if ok[q0:q0 + step, k0:k0 + rows].any()}
    assert set(seen) == want and set(seen.values()) == {1}
    assert pairs == B * Hq * ok.sum()
    # dQ: (b, h, query tile, key step), the same
    seen = collections.Counter()
    pairs = 0
    for b, h, q0, k0s in work["dq"]:
        for k0 in k0s:
            seen[(b, h, q0, k0)] += 1
            pairs += ok[q0:q0 + rows, k0:k0 + step].sum()
    want = {(b, h, q0, k0) for b in range(B) for h in range(Hq)
            for q0 in range(0, Sq, rows) for k0 in range(0, Sk, step)
            if ok[q0:q0 + rows, k0:k0 + step].any()}
    assert set(seen) == want and set(seen.values()) == {1}
    assert pairs == B * Hq * ok.sum()


# the phase-5 train microbatches and gemma2-2b's heads: name, B, S, Hq,
# Hkv, D, window
TRAIN_SHAPES = [
    ("yi-9b", 1, 2048, 32, 4, 128, 0),
    ("hymba-1.5b", 1, 2048, 25, 5, 64, 0),
    ("yi-100m", 4, 256, 12, 4, 64, 0),
    ("gemma2-2b", 1, 2048, 8, 4, 256, 4096),
]


@pytest.mark.parametrize("name,B,S,Hq,Hkv,D,win", TRAIN_SHAPES,
                         ids=[c[0] for c in TRAIN_SHAPES])
def test_split_balances_the_train_shapes(name, B, S, Hq, Hkv, D, win):
    """Every SM gets a dK/dV CTA, and in both launches the CTA with the
    most steps has under twice the mean (the causal mask gives key tile 0
    every query and the last one query step: unsplit, one CTA per (KV
    head, key tile) walked the whole group in series)."""
    work = ref.attention_bwd_split(B, S, S, Hq, Hkv, D, True, win)
    for launch in ("dkdv", "dq"):
        steps = np.array([len(u[-1]) for u in work[launch]])
        assert steps.max() < 2 * steps.mean(), (launch, steps.max(),
                                                steps.mean())
    assert len(work["dkdv"]) >= SMS
    assert work["split"] == {"yi-9b": 8, "hymba-1.5b": 5, "yi-100m": 3,
                             "gemma2-2b": 2}[name]


ORDER_CASES = [
    # name, B, S, Hq, Hkv, D, softcap, window
    ("group4-ragged", 1, 150, 8, 2, 32, 0.0, 0),
    ("group3-cap-window", 2, 97, 6, 2, 32, 30.0, 40),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name,B,S,Hq,Hkv,D,cap,win", ORDER_CASES,
                         ids=[c[0] for c in ORDER_CASES])
def test_split_order_matches_the_plain_backward(dtype, name, B, S, Hq, Hkv,
                                                D, cap, win):
    r = np.random.RandomState(S)
    q, k, v, dout = (torch.from_numpy((r.randn(B, S, h, D) * 0.5)
                                      .astype(np.float32)).to(dtype)
                     for h in (Hq, Hkv, Hkv, Hq))
    out = ref.flash_attention_ref(q, k, v, softcap=cap, window=win)
    lse = ref.flash_attention_lse_ref(q, k, softcap=cap, window=win)
    got = ref.flash_attention_bwd_split_plain(q, k, v, out, dout, lse, True,
                                              cap, win)
    want = ref.flash_attention_bwd_plain(q, k, v, out, dout, lse, True, cap,
                                         win)
    for g, w in zip(got, want):
        assert g.dtype == dtype
        grad_close(g, w, dtype)
