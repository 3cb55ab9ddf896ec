"""Decode attention: the wrappers around ``csrc/paged_decode.cu`` and
``csrc/flash_decode.cu``.

``paged_decode`` replaces the Pallas TPU kernel ``_paged_kernel``/
``_paged_call`` of the JAX package (entry ``flash_decode_paged_native``);
``flash_decode`` replaces ``_decode_kernel``/``flash_decode``, the same
attention over a dense per-sequence cache.  Both kernels run one CTA per
(sequence, KV head) serving all of the group's query heads through one
shared loop (``csrc/decode_group.cuh``: a two-stage ``cp.async`` ring of
K/V tiles, a warp per query head scoring whole positions), so every live
K/V row crosses device memory once per KV head; they are bound by those
bytes (see the notes at the top of the CUDA sources).  Both also split
each (sequence, KV head) over ``n_split`` ranges of whole tiles (16-token
pages for the paged kernel, 32-position tiles for the dense one), one CTA
each, each row's live tiles dealt out evenly, and combine the splits'
fp32 partials in a second launch from the same C entry (one combine
kernel for both, in ``decode_group.cuh``); ``split_count`` picks
``n_split`` so that a small batch still fills the card.  Their plain
versions are ``ref.paged_decode_plain`` and ``ref.flash_decode_plain``
(``ref.paged_decode_split_plain`` and ``ref.flash_decode_split_plain``
repeat the split and combine); ``ops.paged_decode`` and
``ops.flash_decode`` pick between kernel and plain version by the
tensors' device.

``flash_decode`` also writes, with ``with_lse``, each row's fp32
log-sum-exp of its attended scores (-inf where it attends nothing): the
decode plan (``models/sharded.py``) splits a dense cache by sequence over
several shards and combines their partial softmaxes with it.

``paged_decode.launches`` and ``flash_decode.launches`` count the wrapper
calls that launched their kernel (one each, whatever the split;
``flash_decode.lse_launches`` those of them with ``with_lse``);
``paged_decode.last_n_split`` and ``flash_decode.last_n_split`` are the
split counts of their last launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import DTYPE_CODES, HEAD_DIMS, check_tensor


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    "paged_decode": [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                     _I, _P, _F, _F, _P],
    "flash_decode": [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                     _P, _F, _F, _P],
}
# positions per tile of the dense kernel (kTile in csrc/flash_decode.cu);
# the paged kernel's tile is one page
TILE = 32


def split_count(B: int, Hkv: int, max_len: int, tile: int,
                sm_count: int) -> int:
    """Splits per (sequence, KV head) for a decode kernel whose rows
    hold at most ``max_len`` positions in tiles of ``tile``.

    Aims at about two CTAs per SM (B * Hkv * n_split ~ 2 * sm_count), never
    more splits than the ``ceil(max_len / tile)`` live tiles, and one split
    once B * Hkv CTAs already fill the card twice.  The count is trimmed to
    the fewest splits that give the longest row the same tiles per split,
    so no CTA is added that does not shorten the slowest split.
    """
    tiles = max(1, -(-max_len // tile))
    ctas = max(1, B * Hkv)
    if ctas >= 2 * sm_count:
        return 1
    want = min(tiles, -(-2 * sm_count // ctas))
    per = -(-tiles // want)
    return -(-tiles // per)


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The SM count of a CUDA device (cached)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _fn(name: str):
    """The C entry ``name`` of ``csrc/<name>.cu`` (built if needed)."""
    fn = getattr(build.load(name), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def _check_query(kernel: str, q: torch.Tensor, Hkv: int) -> None:
    if not q.is_cuda:
        raise ValueError(f"{kernel} launches a CUDA kernel; "
                         f"use ops.{kernel} for CPU tensors")
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"unsupported dtype {q.dtype}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"head_dim {q.shape[-1]} not in {HEAD_DIMS}")
    if q.shape[1] % Hkv:
        raise ValueError(f"{q.shape[1]} query heads do not group over {Hkv} "
                         "KV heads")


def _check_aligned(**tensors: torch.Tensor) -> None:
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def paged_decode(q: torch.Tensor, k_pages: torch.Tensor,
                 v_pages: torch.Tensor, block_table: torch.Tensor,
                 lens: torch.Tensor, start: torch.Tensor, softcap: float,
                 scale: float) -> torch.Tensor:
    """Launch the paged-decode kernel on CUDA tensors.

    q: [B, Hq, D]; k_pages/v_pages: [P, Hkv, page, D]; block_table:
    [B, n_pages] int32; lens/start: [B] int32.  fp32 or bf16 (q and pools
    alike), D in ``HEAD_DIMS``.  Splits each (sequence, KV head) over
    ``split_count`` page ranges for this batch, table width and card.
    Returns [B, Hq, D] in q's dtype, zeros where ``len == 0``.
    """
    _check_query("paged_decode", q, k_pages.shape[1])
    page, n_pages = k_pages.shape[2], block_table.shape[1]
    n_split = split_count(q.shape[0], k_pages.shape[1], n_pages * page, page,
                          sm_count(q.device))
    return _launch_paged(q, k_pages, v_pages, block_table, lens, start,
                         softcap, scale, n_split)


def _launch_paged(q: torch.Tensor, k_pages: torch.Tensor,
                  v_pages: torch.Tensor, block_table: torch.Tensor,
                  lens: torch.Tensor, start: torch.Tensor, softcap: float,
                  scale: float, n_split: int) -> torch.Tensor:
    """``paged_decode`` at a given ``n_split``; the checks at fixed split
    counts call it directly.  Counts the launch on ``paged_decode.launches``
    and keeps the split count it passed to the kernel in
    ``paged_decode.last_n_split`` (the grid is (B, Hkv, n_split))."""
    P, Hkv, page, _ = k_pages.shape
    _check_query("paged_decode", q, Hkv)
    B, Hq, D = q.shape
    n_pages = block_table.shape[1]
    dev = q.device
    check_tensor("q", q, dev, q.dtype, (B, Hq, D))
    check_tensor("k_pages", k_pages, dev, q.dtype, (P, Hkv, page, D))
    check_tensor("v_pages", v_pages, dev, q.dtype, (P, Hkv, page, D))
    check_tensor("block_table", block_table, dev, torch.int32, (B, n_pages))
    check_tensor("lens", lens, dev, torch.int32, (B,))
    check_tensor("start", start, dev, torch.int32, (B,))
    _check_aligned(k_pages=k_pages, v_pages=v_pages)
    if n_split < 1:
        raise ValueError(f"n_split {n_split} < 1")
    out = torch.empty_like(q)
    if B == 0:
        return out
    part = _partials(B, Hq, D, n_split, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _fn("paged_decode")(
        DTYPE_CODES[q.dtype], q.data_ptr(), k_pages.data_ptr(),
        v_pages.data_ptr(), block_table.data_ptr(), lens.data_ptr(),
        start.data_ptr(), out.data_ptr(), B, Hq, Hkv, page, D, n_pages,
        int(n_split), None if part is None else part.data_ptr(),
        float(softcap), float(scale), stream)
    if err != 0:
        raise RuntimeError(f"paged_decode kernel launch failed: CUDA error "
                           f"{err}")
    paged_decode.launches += 1
    paged_decode.last_n_split = int(n_split)
    return out


def _partials(B: int, Hq: int, D: int, n_split: int, dev):
    """The splits' fp32 scratch, m and l [B, Hq, n_split] then acc
    [.., D]; None for one split."""
    if n_split == 1:
        return None
    return torch.empty(B * Hq * n_split * (D + 2), dtype=torch.float32,
                       device=dev)


paged_decode.launches = 0
paged_decode.last_n_split = 0


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 lens: torch.Tensor, start: torch.Tensor, softcap: float,
                 scale: float, with_lse: bool = False):
    """Launch the dense decode kernel on CUDA tensors.

    q: [B, Hq, D]; k/v: [B, S, Hkv, D] (S >= 1); lens/start: [B] int32 —
    position ``t`` is attended iff ``start <= t < min(len, S)``.  fp32 or
    bf16 (q and caches alike), D in ``HEAD_DIMS``.  Splits each (sequence,
    KV head) over ``split_count`` position ranges for this batch, S and
    card.  Returns [B, Hq, D] in q's dtype, zeros where a row attends
    nothing (``len <= start``); with ``with_lse`` (out, lse), lse [B, Hq]
    fp32 each row's log-sum-exp of its scaled, softcapped scores, -inf
    where it attends nothing (``out`` is the same with and without).
    """
    _check_query("flash_decode", q, k.shape[2])
    n_split = split_count(q.shape[0], k.shape[2], k.shape[1], TILE,
                          sm_count(q.device))
    return _launch(q, k, v, lens, start, softcap, scale, n_split, with_lse)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            lens: torch.Tensor, start: torch.Tensor, softcap: float,
            scale: float, n_split: int, with_lse: bool = False):
    """``flash_decode`` at a given ``n_split``; the checks at fixed split
    counts call it directly.  Counts the launch on ``flash_decode.launches``
    (and on ``flash_decode.lse_launches`` with ``with_lse``) and keeps the
    split count it passed to the kernel in ``flash_decode.last_n_split``
    (the grid is (B, Hkv, n_split))."""
    _check_query("flash_decode", q, k.shape[2])
    B, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    if S < 1:
        raise ValueError("flash_decode needs a cache of at least one "
                         "position")
    dev = q.device
    check_tensor("q", q, dev, q.dtype, (B, Hq, D))
    check_tensor("k", k, dev, q.dtype, (B, S, Hkv, D))
    check_tensor("v", v, dev, q.dtype, (B, S, Hkv, D))
    check_tensor("lens", lens, dev, torch.int32, (B,))
    check_tensor("start", start, dev, torch.int32, (B,))
    _check_aligned(k=k, v=v)
    if n_split < 1:
        raise ValueError(f"n_split {n_split} < 1")
    out = torch.empty_like(q)
    lse = (torch.empty((B, Hq), dtype=torch.float32, device=dev)
           if with_lse else None)
    if B == 0:
        return (out, lse) if with_lse else out
    part = _partials(B, Hq, D, n_split, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _fn("flash_decode")(
        DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        lens.data_ptr(), start.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), B, S, Hq, Hkv, D,
        int(n_split), None if part is None else part.data_ptr(),
        float(softcap), float(scale), stream)
    if err != 0:
        raise RuntimeError(f"flash_decode kernel launch failed: CUDA error "
                           f"{err}")
    flash_decode.launches += 1
    flash_decode.lse_launches += int(with_lse)
    flash_decode.last_n_split = int(n_split)
    return (out, lse) if with_lse else out


flash_decode.launches = 0
flash_decode.lse_launches = 0
flash_decode.last_n_split = 0
