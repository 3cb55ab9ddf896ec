"""Plain PyTorch versions of every kernel (the allclose ground truth).

``flash_attention_ref``, ``flash_decode_ref``, ``flash_decode_paged_ref``,
``ssd_chunk_ref`` and ``ssd_reference`` are the port's copies of the JAX
package's oracles, with the same signatures and layouts;
``flash_attention_ref`` also takes a ``q_offset`` (query row i at position
q_offset + i), which the prefill kernel takes for chunked prefill.
``paged_decode_plain`` and ``flash_decode_plain`` are the plain versions of
the paged and dense decode kernels themselves: the first reads the
kernel-native pool ``[P, Hkv, page, D]``, both take a per-sequence
``start`` and return zeros where ``len == 0``, as the kernels do
(``flash_decode_ref`` and ``flash_decode_paged_ref`` return the mean of V
there, because their softmax over an all-masked row is uniform).
``flash_decode_split_plain`` repeats the dense kernel's split over
positions (``split_ranges``) and its combine step (the same function as
``flash_decode_plain``, summed in the kernel's order of splits);
``paged_decode_split_plain`` does the same for the paged kernel, whose
tile is a page.
``ssd_chunk_plain`` is the plain version of the SSD chunk kernel: it takes
B/C per group, as the kernel does, where ``ssd_chunk_ref`` takes them
already broadcast to heads.
"""
from __future__ import annotations

import torch

NEG_INF = -2.0 ** 30


def _expand(k: torch.Tensor, Hq: int) -> torch.Tensor:
    rep = Hq // k.shape[2]
    if rep == 1:
        return k
    return torch.repeat_interleave(k, rep, dim=2)


def flash_attention_ref(q, k, v, *, causal=True, softcap=0.0, window=0,
                        q_offset=0):
    """q: [B, Sq, Hq, D]; k/v: [B, Sk, Hkv, D] -> [B, Sq, Hq, D]; query
    row i sits at position ``q_offset + i`` for the causal and window
    masks."""
    B, Sq, Hq, D = q.shape
    Sk = k.shape[1]
    k = _expand(k, Hq)
    v = _expand(v, Hq)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / (D ** 0.5)
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    qp = q_offset + torch.arange(Sq, device=q.device)[:, None]
    kp = torch.arange(Sk, device=q.device)[None, :]
    ok = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        ok = ok & (kp <= qp)
    if window > 0:
        ok = ok & (kp > qp - window)
    s = torch.where(ok[None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def flash_decode_ref(q, k, v, lens, *, softcap=0.0, start=None):
    """q: [B, Hq, D]; k/v: [B, S, Hkv, D]; lens [B]; start [B] lower bound."""
    B, Hq, D = q.shape
    S = k.shape[1]
    k = _expand(k, Hq)
    v = _expand(v, Hq)
    s = torch.einsum("bhd,bkhd->bhk", q.float(), k.float()) / (D ** 0.5)
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    pos = torch.arange(S, device=q.device)[None, None, :]
    ok = pos < lens[:, None, None]
    if start is not None:
        ok = ok & (pos >= start[:, None, None])
    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhk,bkhd->bhd", p, v.float()).to(q.dtype)


def flash_decode_paged_ref(q, k_pages, v_pages, block_table, lens, *,
                           softcap=0.0, start=None):
    """Page-major pools [P, page, Hkv, D]: gather pages, then dense decode."""
    k = k_pages[block_table.long()]        # [B, n, page, Hkv, D]
    v = v_pages[block_table.long()]
    B_, n, p, H, D = k.shape
    k = k.reshape(B_, n * p, H, D)
    v = v.reshape(B_, n * p, H, D)
    return flash_decode_ref(q, k, v, lens, softcap=softcap, start=start)


def gather_pages_dense(k_pages, v_pages, block_table):
    """Kernel-native pools [P, Hkv, page, D] gathered through a block table
    into dense [B, n_pages * page, Hkv, D] caches."""
    k = k_pages[block_table.long()]        # [B, n, Hkv, page, D]
    v = v_pages[block_table.long()]
    B, n, Hkv, page, D = k.shape
    k = k.transpose(2, 3).reshape(B, n * page, Hkv, D)
    v = v.transpose(2, 3).reshape(B, n * page, Hkv, D)
    return k, v


def flash_decode_plain(q, k, v, lens, start, softcap: float,
                       scale: float):
    """Plain version of the dense decode kernel.

    q: [B, Hq, D]; k/v: [B, S, Hkv, D]; lens/start: [B] int32 — position
    ``t`` is attended iff ``start <= t < len``.  fp32 softmax; rows with
    ``len == 0`` are zero.  Returns [B, Hq, D] in q's dtype.
    """
    Hq = q.shape[1]
    k = _expand(k, Hq)
    v = _expand(v, Hq)
    s = torch.einsum("bhd,bkhd->bhk", q.float(), k.float()) * scale
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    pos = torch.arange(k.shape[1], device=q.device)[None, None, :]
    ok = (pos < lens[:, None, None]) & (pos >= start[:, None, None])
    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhk,bkhd->bhd", p, v.float())
    out = torch.where((lens > 0)[:, None, None], out, torch.zeros_like(out))
    return out.to(q.dtype)


def split_ranges(lens, start, S: int, n_split: int, tile: int = 32):
    """The positions each split of the dense decode kernel walks.

    Row b's live tiles run from the tile that holds ``max(start, 0)`` to
    the one that holds ``min(len, S) - 1``; with n of them, split s takes
    tiles ``[s * n // n_split, (s + 1) * n // n_split)`` of that run, so
    the live work is dealt out evenly and a split is empty only where
    ``n < n_split``.  Returns (lo, hi): [B, n_split] int64 position
    bounds, ``lo == hi`` for an empty split.
    """
    limit = torch.clamp(lens.long(), max=S)
    live_end = torch.where(limit > 0, (limit - 1) // tile + 1,
                           torch.zeros_like(limit))
    first = torch.minimum(torch.clamp(start.long(), min=0) // tile,
                          live_end)
    n = (live_end - first)[:, None]
    s = torch.arange(n_split, device=lens.device)[None, :]
    lo = (first[:, None] + s * n // n_split) * tile
    hi = (first[:, None] + (s + 1) * n // n_split) * tile
    return lo, hi


def flash_decode_split_plain(q, k, v, lens, start, softcap: float,
                             scale: float, n_split: int, tile: int = 32):
    """Plain version of the dense decode kernel's split and combine.

    Each row's live tiles are dealt out over ``n_split`` splits as
    ``split_ranges`` says; split s attends the positions of its range
    inside ``[start, min(len, S))`` and keeps an fp32 partial
    ``(m, l, acc)`` (``m = -inf``, ``l = 0`` where it attends nothing); the
    combine rescales each by ``exp(m - max m)`` and divides the summed acc
    by the summed l, zeros where no split attended anything (``len ==
    0``).  Same arguments as ``flash_decode_plain``.
    """
    Hq = q.shape[1]
    S = k.shape[1]
    k = _expand(k, Hq)
    v = _expand(v, Hq).float()
    s = torch.einsum("bhd,bkhd->bhk", q.float(), k.float()) * scale
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    pos = torch.arange(S, device=q.device)[None, None, :]
    ok = (pos < lens[:, None, None]) & (pos >= start[:, None, None])
    lo, hi = split_ranges(lens, start, S, n_split, tile)
    ms, ls, accs = [], [], []
    for i in range(n_split):
        own = (ok & (pos >= lo[:, i, None, None])
               & (pos < hi[:, i, None, None]))
        m = torch.where(own, s, torch.full_like(s, -torch.inf)).amax(-1)
        p = torch.where(own, torch.exp(s - m[..., None]),
                        torch.zeros_like(s))
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("bhk,bkhd->bhd", p, v))
    m = torch.stack(ms)                                   # [n, B, Hq]
    top = m.amax(0)
    w = torch.where(m > -torch.inf, torch.exp(m - top), torch.zeros_like(m))
    l_sum = (w * torch.stack(ls)).sum(0)
    acc = (w[..., None] * torch.stack(accs)).sum(0)
    out = torch.where(l_sum[..., None] > 0,
                      acc / torch.clamp(l_sum, min=1e-30)[..., None],
                      torch.zeros_like(acc))
    return out.to(q.dtype)


def paged_decode_plain(q, k_pages, v_pages, block_table, lens, start,
                       softcap: float, scale: float):
    """Plain version of the paged-decode kernel.

    q: [B, Hq, D]; k_pages/v_pages: [P, Hkv, page, D] (kernel-native);
    block_table: [B, n_pages] int32; lens/start: [B] int32 — position ``t``
    is attended iff ``start <= t < len``.  fp32 softmax; rows with
    ``len == 0`` are zero.  Returns [B, Hq, D] in q's dtype.
    """
    k, v = gather_pages_dense(k_pages, v_pages, block_table)
    return flash_decode_plain(q, k, v, lens, start, softcap, scale)


def paged_decode_split_plain(q, k_pages, v_pages, block_table, lens, start,
                             softcap: float, scale: float, n_split: int):
    """Plain version of the paged-decode kernel's split and combine.

    The pages are gathered into a dense cache of ``n_pages * page``
    positions (``gather_pages_dense``) and each row's live pages dealt out
    over ``n_split`` splits, a page being the tile
    (``flash_decode_split_plain`` with ``tile = page``).  Same arguments as
    ``paged_decode_plain``.
    """
    k, v = gather_pages_dense(k_pages, v_pages, block_table)
    return flash_decode_split_plain(q, k, v, lens, start, softcap, scale,
                                    n_split, tile=k_pages.shape[2])


def ssd_chunk_ref(x, dt, A, B_, C_):
    """Within-chunk SSD oracle: x [B,Nc,Q,H,P], dt [B,Nc,Q,H], A [H],
    B_/C_ [B,Nc,Q,H,N] -> (y [B,Nc,Q,H,P], S [B,Nc,H,P,N])."""
    dtA = dt * A[None, None, None, :]
    cs = torch.cumsum(dtA, dim=2)
    Q = x.shape[2]
    diff = cs[:, :, :, None, :] - cs[:, :, None, :, :]
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    M = torch.where(tri[None, None, :, :, None], torch.exp(diff),
                    torch.zeros_like(diff))
    cb = torch.einsum("bcthn,bcshn->bchts", C_, B_)
    scores = cb * torch.movedim(M, -1, 2)
    xdt = x * dt[..., None]
    y = torch.einsum("bchts,bcshp->bcthp", scores, xdt)
    total = cs[:, :, -1, :]
    w = torch.exp(total[:, :, None, :] - cs) * dt
    S = torch.einsum("bcqh,bcqhn,bcqhp->bchpn", w, B_, x)
    return y, S


def ssd_chunk_plain(x, dt, A, B_, C_):
    """Plain version of the SSD chunk kernel: x [B,Nc,Q,H,P], dt [B,Nc,Q,H],
    A [H], B_/C_ [B,Nc,Q,G,N] per group (head h reads group h // (H // G))
    -> (y [B,Nc,Q,H,P], S [B,Nc,H,P,N])."""
    rep = x.shape[3] // B_.shape[3]
    return ssd_chunk_ref(x, dt, A, torch.repeat_interleave(B_, rep, dim=3),
                         torch.repeat_interleave(C_, rep, dim=3))


def ssd_reference(xs, dt, A, B_, C_, init_state=None):
    """Token-by-token recurrent SSD oracle: xs [B,L,H,P], dt [B,L,H], A [H],
    B_/C_ [B,L,G,N] -> (y [B,L,H,P], final state [B,H,P,N])."""
    Bsz, L, H, P = xs.shape
    N = B_.shape[3]
    rep = H // B_.shape[2]
    B_h = torch.repeat_interleave(B_, rep, dim=2)
    C_h = torch.repeat_interleave(C_, rep, dim=2)
    state = (torch.zeros((Bsz, H, P, N), dtype=torch.float32,
                         device=xs.device)
             if init_state is None else init_state)
    ys = []
    for t in range(L):
        a = torch.exp(dt[:, t] * A[None, :])
        state = state * a[..., None, None] + torch.einsum(
            "bh,bhp,bhn->bhpn", dt[:, t], xs[:, t], B_h[:, t])
        ys.append(torch.einsum("bhn,bhpn->bhp", C_h[:, t], state))
    return torch.stack(ys, dim=1), state
