"""Dispatch between each kernel and its plain version by device.

CPU tensors go to the plain PyTorch version (``ref``); CUDA tensors go to
the hand-written kernel, which launches or raises — there is no fallback.
There is no head-dim padding here: pools and activations keep
``D = head_dim`` (the 128-lane pad of the JAX package is a TPU matter).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import flash_decode as _fd
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as _ssd


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, softcap: float = 0.0,
                    window: int = 0, q_offset: int = 0) -> torch.Tensor:
    """q [B, Sq, Hq, D], k/v [B, Sk, Hkv, D] -> [B, Sq, Hq, D]; query row
    i at position ``q_offset + i`` (a prefill chunk after ``q_offset``
    resident tokens)."""
    if q.is_cuda:
        return _fa.flash_attention(q, k, v, causal=causal, softcap=softcap,
                                   window=window, q_offset=q_offset)
    return ref.flash_attention_ref(q, k, v, causal=causal, softcap=softcap,
                                   window=window, q_offset=q_offset)


def paged_decode(q: torch.Tensor, k_pages: torch.Tensor,
                 v_pages: torch.Tensor, block_table: torch.Tensor,
                 lens: torch.Tensor, start: torch.Tensor, *,
                 softcap: float = 0.0) -> torch.Tensor:
    """q [B, Hq, D]; pools [P, Hkv, page, D]; block_table [B, n_pages];
    lens/start [B] -> [B, Hq, D] over positions [start, len), scores
    scaled by 1/sqrt(D)."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    if q.is_cuda:
        return _fd.paged_decode(q, k_pages, v_pages, block_table, lens, start,
                                softcap, scale)
    return ref.paged_decode_plain(q, k_pages, v_pages, block_table, lens,
                                  start, softcap, scale)


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 lens: torch.Tensor, start: torch.Tensor, *,
                 softcap: float = 0.0) -> torch.Tensor:
    """q [B, Hq, D]; dense caches k/v [B, S, Hkv, D]; lens/start [B] ->
    [B, Hq, D] over positions [start, len), scores scaled by 1/sqrt(D)."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    if q.is_cuda:
        return _fd.flash_decode(q, k, v, lens, start, softcap, scale)
    return ref.flash_decode_plain(q, k, v, lens, start, softcap, scale)


def ssd_chunk(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
              B_: torch.Tensor, C_: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Within-chunk SSD, fp32: x [B, Nc, Q, H, P], dt [B, Nc, Q, H], A [H],
    B_/C_ [B, Nc, Q, G, N] per group -> (y [B, Nc, Q, H, P],
    S [B, Nc, H, P, N])."""
    if x.is_cuda:
        return _ssd.ssd_chunk(x, dt, A, B_, C_)
    return ref.ssd_chunk_plain(x, dt, A, B_, C_)


def launch_counts() -> dict[str, int]:
    """Kernel launches so far, by kernel."""
    return {"paged_decode": _fd.paged_decode.launches,
            "flash_decode": _fd.flash_decode.launches,
            "flash_attention": _fa.flash_attention.launches,
            "ssd_chunk": _ssd.ssd_chunk.launches}


def reset_launch_counts() -> None:
    _fd.paged_decode.launches = 0
    _fd.flash_decode.launches = 0
    _fa.flash_attention.launches = 0
    _fa.flash_attention.offset_launches = 0
    _ssd.ssd_chunk.launches = 0
