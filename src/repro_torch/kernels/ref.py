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
``flash_attention_bwd_plain`` is the plain version of the prefill
attention's backward kernel (the formulas written out, not autograd), and
``flash_attention_lse_ref`` the log-sum-exp the forward kernel writes for
it; ``attention_bwd_split`` lists the work of the backward's bf16 CTAs
and ``flash_attention_bwd_split_plain`` sums the gradients in their
order.
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
    masks; ``q_offset`` is an int or an integer tensor holding one offset
    or one per batch row, as the kernel's device-offset form takes it."""
    s, _, _ = _scores(q, k, causal, softcap, window, q_offset)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p,
                        _expand(v, q.shape[2]).float()).to(q.dtype)


def _scores(q, k, causal, softcap, window, q_offset):
    """(scaled, softcapped scores [B, Hq, Sq, Sk] fp32 with NEG_INF where
    masked, tanh(z / softcap) or None, the mask [1 or B, 1, Sq, Sk]) of
    the prefill attention, K expanded to the query heads; a tensor
    ``q_offset`` holds one offset or one per batch row."""
    Sq, Hq, D = q.shape[1], q.shape[2], q.shape[3]
    Sk = k.shape[1]
    z = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                     _expand(k, Hq).float()) / (D ** 0.5)
    t = None
    if softcap > 0:
        t = torch.tanh(z / softcap)
        z = softcap * t
    qp = torch.arange(Sq, device=q.device)[:, None]
    if isinstance(q_offset, torch.Tensor):
        qp = q_offset.long().reshape(-1, 1, 1, 1) + qp      # [B, 1, Sq, 1]
    else:
        qp = q_offset + qp
    kp = torch.arange(Sk, device=q.device)[None, :]
    ok = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        ok = ok & (kp <= qp)
    if window > 0:
        ok = ok & (kp > qp - window)
    ok = ok.reshape(-1, 1, Sq, Sk)
    return torch.where(ok, z, torch.full_like(z, NEG_INF)), t, ok


def flash_attention_lse_ref(q, k, *, causal=True, softcap=0.0, window=0,
                            q_offset=0):
    """Each query row's log-sum-exp over its unmasked scaled (softcapped)
    scores: lse [B, Hq, Sq] fp32, what the prefill kernel writes with
    ``with_lse``."""
    s, _, _ = _scores(q, k, causal, softcap, window, q_offset)
    return torch.logsumexp(s, dim=-1)


def flash_attention_bwd_plain(q, k, v, out, dout, lse, causal=True,
                              softcap=0.0, window=0):
    """Plain version of the prefill attention's backward kernel: the same
    formulas written out in torch (not autograd), queries at positions 0..

    q, out, dout [B, Sq, Hq, D]; k/v [B, Sk, Hkv, D]; lse [B, Hq, Sq] fp32.
    P = exp(s - lse) in fp32, delta = rowsum(dO * O), dS = P (dP - delta)
    (times 1 - tanh^2(z / softcap) under a softcap); dV = P^T dO,
    dK = scale dS^T Q, dQ = scale dS K, dK and dV summed over each KV
    head's group.  In bf16, P and dS are rounded to bf16 as the operands of
    their products, as the kernel rounds them.  Returns (dq, dk, dv) in the
    inputs' dtype.
    """
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    scale = 1.0 / (D ** 0.5)
    s, t, ok = _scores(q, k, causal, softcap, window, 0)
    p = torch.where(ok, torch.exp(s - lse[..., None]),
                    torch.zeros_like(s))                     # [B, Hq, Sq, Sk]
    do = dout.float()
    delta = (do * out.float()).sum(-1).transpose(1, 2)      # [B, Hq, Sq]
    dp = torch.einsum("bqhd,bkhd->bhqk", do, _expand(v, Hq).float())
    ds = p * (dp - delta[..., None])
    if t is not None:
        ds = ds * (1 - t * t)
    if q.dtype == torch.bfloat16:
        p = p.to(torch.bfloat16).float()
        ds = ds.to(torch.bfloat16).float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, _expand(k, Hq).float()) * scale
    rep = Hq // Hkv
    dk = dk.reshape(B, Sk, Hkv, rep, D).sum(3)
    dv = dv.reshape(B, Sk, Hkv, rep, D).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def attention_bwd_split(B: int, Sq: int, Sk: int, Hq: int, Hkv: int,
                        D: int, causal: bool = True, window: int = 0
                        ) -> dict:
    """The work of the backward kernel's bf16 launches
    (``csrc/flash_attention_bwd.cu``), as its CTAs take it.

    dK/dV: one CTA per (batch, KV head, 64-key tile, rank), the ranks
    forming a cluster of ``split`` CTAs (the largest divisor of the group
    up to 8); rank r walks the group's query heads r, r + split, .. and,
    for each, the query steps (64 queries, 32 at D = 256) that see a key
    of its tile.  dQ: one CTA per (batch, query head, 64-query tile)
    walking the key steps (64 keys, 32 at D = 256) its queries see.
    Returns {"split", "step", "dkdv": [(b, hk, k0, rank, [(h, q0), ..])],
    "dq": [(b, h, q0, [k0, ..])]}.
    """
    rows, step = 64, (32 if D == 256 else 64)
    group = Hq // Hkv
    split = max(c for c in range(1, min(group, 8) + 1) if group % c == 0)
    dkdv = []
    for b in range(B):
        for hk in range(Hkv):
            for k0 in range(0, Sk, rows):
                k_last = min(k0 + rows, Sk) - 1
                qt_begin = k0 // step if causal else 0
                q_stop = min(Sq, k_last + window) if window > 0 else Sq
                qts = range(qt_begin, -(-q_stop // step))
                for rank in range(split):
                    heads = range(hk * group + rank, (hk + 1) * group, split)
                    dkdv.append((b, hk, k0, rank,
                                 [(h, qt * step) for h in heads
                                  for qt in qts]))
    dq = []
    for b in range(B):
        for h in range(Hq):
            for q0 in range(0, Sq, rows):
                kt_end = -(-Sk // step)
                if causal:
                    kt_end = min(kt_end, (min(q0 + rows, Sq) - 1) // step + 1)
                kt_begin = max(0, q0 - window + 1) // step if window > 0 else 0
                dq.append((b, h, q0, [kt * step
                                      for kt in range(kt_begin, kt_end)]))
    return {"split": split, "step": step, "dkdv": dkdv, "dq": dq}


def flash_attention_bwd_split_plain(q, k, v, out, dout, lse, causal=True,
                                    softcap=0.0, window=0):
    """``flash_attention_bwd_plain`` summed in the bf16 kernels' order:
    each dK/dV CTA of ``attention_bwd_split`` adds its steps' P^T dO and
    dS^T Q into fp32 partials, a cluster's partials are summed in rank
    order (dK then scaled), and each dQ CTA adds its steps' dS K.  P and dS
    are rounded to bf16 as product operands where the inputs are bf16.
    Returns (dq, dk, dv) in the inputs' dtype.
    """
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    scale = 1.0 / (D ** 0.5)
    work = attention_bwd_split(B, Sq, Sk, Hq, Hkv, D, causal, window)
    rows, step = 64, work["step"]
    bf16 = q.dtype == torch.bfloat16
    qf, kf, vf, of, gf = (t.float() for t in (q, k, v, out, dout))
    delta = (gf * of).sum(-1)                               # [B, Sq, Hq]

    def tile(b, h, q0, nq, k0, nk):
        """P and dS of queries [q0, q0 + nq), keys [k0, k0 + nk) of head
        h, cut to the tensors' ends."""
        hk = h // group
        qs = slice(q0, min(q0 + nq, Sq))
        ks = slice(k0, min(k0 + nk, Sk))
        z = qf[b, qs, h] @ kf[b, ks, hk].T * scale
        t = None
        if softcap > 0:
            t = torch.tanh(z / softcap)
            z = softcap * t
        qp = torch.arange(qs.start, qs.stop)[:, None]
        kp = torch.arange(ks.start, ks.stop)[None, :]
        ok = torch.ones_like(z, dtype=torch.bool)
        if causal:
            ok = ok & (kp <= qp)
        if window > 0:
            ok = ok & (kp > qp - window)
        p = torch.where(ok, torch.exp(z - lse[b, h, qs, None]),
                        torch.zeros_like(z))
        dp = gf[b, qs, h] @ vf[b, ks, hk].T
        ds = p * (dp - delta[b, qs, h, None])
        if t is not None:
            ds = ds * (1 - t * t)
        if bf16:
            p = p.to(torch.bfloat16).float()
            ds = ds.to(torch.bfloat16).float()
        return qs, ks, p, ds

    dk = torch.zeros(B, Sk, Hkv, D)
    dv = torch.zeros(B, Sk, Hkv, D)
    parts = {}
    for b, hk, k0, rank, steps in work["dkdv"]:
        nk = min(k0 + rows, Sk) - k0
        pdk, pdv = torch.zeros(nk, D), torch.zeros(nk, D)
        for h, q0 in steps:
            qs, ks, p, ds = tile(b, h, q0, step, k0, rows)
            pdv += p.T @ gf[b, qs, h]
            pdk += ds.T @ qf[b, qs, h]
        parts.setdefault((b, hk, k0), []).append((rank, pdk, pdv))
    for (b, hk, k0), ranked in parts.items():
        ranked.sort(key=lambda x: x[0])
        sk, sv = ranked[0][1].clone(), ranked[0][2].clone()
        for _, pdk, pdv in ranked[1:]:
            sk += pdk
            sv += pdv
        dk[b, k0:k0 + sk.shape[0], hk] = sk * scale
        dv[b, k0:k0 + sv.shape[0], hk] = sv
    dq = torch.zeros(B, Sq, Hq, D)
    for b, h, q0, k0s in work["dq"]:
        acc = torch.zeros(min(q0 + rows, Sq) - q0, D)
        for k0 in k0s:
            qs, ks, _, ds = tile(b, h, q0, rows, k0, step)
            acc += ds @ kf[b, ks, h // group]
        dq[b, q0:q0 + acc.shape[0], h] = acc * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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
                       scale: float, with_lse: bool = False):
    """Plain version of the dense decode kernel.

    q: [B, Hq, D]; k/v: [B, S, Hkv, D]; lens/start: [B] int32 — position
    ``t`` is attended iff ``start <= t < len``.  fp32 softmax; rows that
    attend nothing (``len <= start``) are zero.  Returns [B, Hq, D] in q's
    dtype; with ``with_lse`` (out, lse), lse [B, Hq] fp32 the log-sum-exp
    of each row's attended scaled, softcapped scores, -inf where it
    attends nothing.
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
    live = ok.any(-1)                                     # [B, 1]
    out = torch.where(live[..., None], out, torch.zeros_like(out))
    if not with_lse:
        return out.to(q.dtype)
    lse = torch.where(live, torch.logsumexp(s, dim=-1),
                      torch.full_like(s[..., 0], -torch.inf))
    return out.to(q.dtype), lse


def split_ranges(lens, start, S: int, n_split: int, tile: int = 32):
    """The positions each split of the dense decode kernel walks.

    Row b's live tiles run from the tile that holds ``max(start, 0)`` to
    the one that holds ``min(len, S) - 1``; with n of them, split s takes
    tiles ``[s * n // n_split, (s + 1) * n // n_split)`` of that run, so
    the live work is dealt out evenly and a split is empty only where
    ``n < n_split``; a row that attends nothing (``len <= start``) has no
    live tile.  Returns (lo, hi): [B, n_split] int64 position
    bounds, ``lo == hi`` for an empty split.
    """
    limit = torch.clamp(lens.long(), max=S)
    live_end = torch.where(limit > 0, (limit - 1) // tile + 1,
                           torch.zeros_like(limit))
    start0 = torch.clamp(start.long(), min=0)
    first = torch.minimum(start0 // tile, live_end)
    n = torch.where(limit > start0, live_end - first,
                    torch.zeros_like(first))[:, None]
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


def ssd_chunk_bwd_plain(x, dt, A, B_, C_, dy, dS):
    """Plain version of the SSD chunk kernel's backward: the formulas
    written out in torch (not autograd), in the inputs' dtype.

    Per (batch, chunk) and head h of group g, with cs the inclusive cumsum
    of dt * A[h], L_ts = exp(cs_t - cs_s) for t >= s (else 0),
    CB_ts = C_t . B_s, W_ts = CB_ts L_ts dt_s and
    w_s = exp(cs_{Q-1} - cs_s) dt_s (so y = W x, S = sum_s w_s x_s B_s^T):
    dW = dy x^T (t >= s), dCB = dW L dt_s, R = dW W, dw_s = x_s . (dS B_s),
    Z = dw w; dx = W^T dy + w (dS B), dC = dCB B, dB = dCB^T C
    + w (dS^T x), dcs_t = sum_s R_ts - sum_t' R_t't - Z_t (+ sum Z at
    t = Q - 1), ddt_s = sum_t dW CB L + dw_s exp(cs_{Q-1} - cs_s)
    + A sum_{t >= s} dcs_t, dA = sum over batch, chunks and s of
    dt_s sum_{t >= s} dcs_t.

    x, dy [B,Nc,Q,H,P]; dt [B,Nc,Q,H]; A [H]; B_/C_ [B,Nc,Q,G,N] per group;
    dS [B,Nc,H,P,N].  Returns (dx, ddt, dA, dB, dC), dB and dC per group
    (summed over the group's heads).
    """
    Bsz, Nc, Q, H, P = x.shape
    G, N = B_.shape[3], B_.shape[4]
    rep = H // G
    Bh = torch.repeat_interleave(B_, rep, dim=3)
    Ch = torch.repeat_interleave(C_, rep, dim=3)
    cs = torch.cumsum(dt * A, dim=2)                       # [B,Nc,Q,H]
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    diff = (cs[:, :, :, None, :] - cs[:, :, None, :, :]).permute(0, 1, 4, 2,
                                                                 3)
    L = torch.where(tri, torch.exp(torch.where(tri, diff,
                                               torch.zeros_like(diff))),
                    torch.zeros_like(diff))                # [B,Nc,H,t,s]
    dts = dt.permute(0, 1, 3, 2)[:, :, :, None, :]         # [B,Nc,H,1,s]
    CB = torch.einsum("bcthn,bcshn->bchts", Ch, Bh)
    W = CB * L * dts
    decay = torch.exp(cs[:, :, -1:] - cs)                  # [B,Nc,Q,H]
    w = decay * dt
    dW = torch.einsum("bcthp,bcshp->bchts", dy, x) * tri
    dCB = dW * L * dts
    dSB = torch.einsum("bchpn,bcshn->bcshp", dS, Bh)       # dS B_s
    dSx = torch.einsum("bchpn,bcshp->bcshn", dS, x)        # dS^T x_s
    dx = torch.einsum("bchts,bcthp->bcshp", W, dy) + w[..., None] * dSB
    dC = torch.einsum("bchts,bcshn->bcthn", dCB, Bh)
    dB = torch.einsum("bchts,bcthn->bcshn", dCB, Ch) + w[..., None] * dSx
    dw = (x * dSB).sum(-1)                                 # [B,Nc,Q,H]
    R = dW * W
    Z = dw * w
    dcs = (R.sum(-1) - R.sum(-2)).permute(0, 1, 3, 2) - Z
    dcs[:, :, -1] += Z.sum(2)
    suf = torch.flip(torch.cumsum(torch.flip(dcs, [2]), dim=2), [2])
    K = (dW * CB * L).sum(-2).permute(0, 1, 3, 2)          # [B,Nc,Q,H]
    ddt = K + dw * decay + A * suf
    dA = (dt * suf).sum((0, 1, 2))
    dB = dB.reshape(Bsz, Nc, Q, G, rep, N).sum(4)
    dC = dC.reshape(Bsz, Nc, Q, G, rep, N).sum(4)
    return dx, ddt, dA, dB, dC


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
