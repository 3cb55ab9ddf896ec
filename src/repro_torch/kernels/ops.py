"""Dispatch between each kernel and its plain version by device.

CPU tensors go to the plain PyTorch version (``ref``); CUDA tensors go to
the hand-written kernel, which launches or raises — there is no fallback.
There is no head-dim padding here: pools and activations keep
``D = head_dim`` (the 128-lane pad of the JAX package is a TPU matter).

Gradients: on the CPU autograd differentiates the plain versions.  On the
card the prefill kernel and the SSD chunk kernel run inside
``autograd.Function``s whose backwards are the hand-written
``flash_attention_bwd`` and ``ssd_chunk_bwd`` kernels.  The decode kernels
have no backward (decoding does not train), so their CUDA branches raise
when autograd would need a gradient through them (``grad_guard``) instead
of silently dropping it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import flash_attention_bwd as _fab
from repro_torch.kernels import flash_decode as _fd
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_chunk_bwd as _ssb
from repro_torch.kernels import ssd_scan as _ssd


def _needs_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def grad_guard(kernel: str, *tensors: torch.Tensor) -> None:
    """Raise if autograd would need a gradient through ``kernel``, a CUDA
    decode kernel, which has no backward: grad mode is on and an input
    requires grad."""
    if _needs_grad(*tensors):
        raise RuntimeError(
            f"{kernel}: the CUDA kernel has no backward (decoding does not "
            f"train), so it cannot run where a gradient is needed; call it "
            f"under torch.no_grad() or on tensors that do not require grad")


class _FlashAttention(torch.autograd.Function):
    """The prefill kernel with the hand-written backward kernel: the
    forward also writes each row's log-sum-exp and saves q, k, v, out and
    lse for the backward (``kernels/flash_attention_bwd.py``: in bf16
    ``wgmma`` kernels, dK/dV summed over the group's heads by a cluster in
    a fixed order)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, softcap, window, q_offset):
        ctx.params = (causal, softcap, window, q_offset)
        out, lse = _fa.flash_attention(q, k, v, causal=causal,
                                       softcap=softcap, window=window,
                                       q_offset=q_offset, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, softcap, window, q_offset = ctx.params
        # the kernel takes raw, 16-byte aligned pointers: a strided view of
        # dO would be read as if it were contiguous
        dout = dout.contiguous()
        if dout.data_ptr() % 16:
            dout = dout.clone()
        dq, dk, dv = _fab.flash_attention_bwd(
            q, k, v, out, dout, lse, causal=causal, softcap=softcap,
            window=window, q_offset=q_offset)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, softcap: float = 0.0,
                    window: int = 0, q_offset: int | torch.Tensor = 0
                    ) -> torch.Tensor:
    """q [B, Sq, Hq, D], k/v [B, Sk, Hkv, D] -> [B, Sq, Hq, D]; query row
    i at position ``q_offset + i`` (a prefill chunk after ``q_offset``
    resident tokens).  ``q_offset`` is a host int or an int32 tensor on
    q's device, one offset or one per batch row (the kernel's
    device-offset form, which a captured CUDA graph replays at any
    offset).  Differentiable on both devices (on the card through the
    backward kernel, which takes no query offset); where no gradient is
    needed (serving) the card launches the forward kernel alone."""
    if q.is_cuda:
        if _needs_grad(q, k, v):
            if isinstance(q_offset, torch.Tensor):
                raise ValueError("the prefill backward takes no device "
                                 "q_offset")
            return _FlashAttention.apply(q, k, v, causal, float(softcap),
                                         int(window), int(q_offset))
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
        grad_guard("paged_decode", q, k_pages, v_pages)
        return _fd.paged_decode(q, k_pages, v_pages, block_table, lens, start,
                                softcap, scale)
    return ref.paged_decode_plain(q, k_pages, v_pages, block_table, lens,
                                  start, softcap, scale)


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 lens: torch.Tensor, start: torch.Tensor, *,
                 softcap: float = 0.0, with_lse: bool = False):
    """q [B, Hq, D]; dense caches k/v [B, S, Hkv, D]; lens/start [B] ->
    [B, Hq, D] over positions [start, len), scores scaled by 1/sqrt(D);
    with ``with_lse`` (out, lse [B, Hq] fp32), lse -inf on rows that
    attend nothing."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    if q.is_cuda:
        grad_guard("flash_decode", q, k, v)
        return _fd.flash_decode(q, k, v, lens, start, softcap, scale,
                                with_lse)
    return ref.flash_decode_plain(q, k, v, lens, start, softcap, scale,
                                  with_lse)


class _SSDChunk(torch.autograd.Function):
    """The SSD chunk kernel with the hand-written backward kernel (3xTF32
    on the tensor cores, ``kernels/ssd_chunk_bwd.py``): the forward saves
    x, dt, A, B and C for the backward."""

    @staticmethod
    def forward(ctx, x, dt, A, B_, C_):
        y, S = _ssd.ssd_chunk(x, dt, A, B_, C_)
        ctx.save_for_backward(x, dt, A, B_, C_)
        return y, S

    @staticmethod
    def backward(ctx, dy, dS):
        # an unused output's gradient arrives as zeros (materialized); a
        # used one may be a strided view (``ssd_chunked`` slices y after a
        # reshape), and the kernel reads raw contiguous rows
        return _ssb.ssd_chunk_bwd(*ctx.saved_tensors, dy.contiguous(),
                                  dS.contiguous())


def ssd_chunk(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
              B_: torch.Tensor, C_: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Within-chunk SSD, fp32: x [B, Nc, Q, H, P], dt [B, Nc, Q, H], A [H],
    B_/C_ [B, Nc, Q, G, N] per group -> (y [B, Nc, Q, H, P],
    S [B, Nc, H, P, N]).  Differentiable on both devices (on the card
    through the backward kernel); where no gradient is needed (serving)
    the card launches the forward kernel alone."""
    if x.is_cuda:
        if _needs_grad(x, dt, A, B_, C_):
            return _SSDChunk.apply(x, dt, A, B_, C_)
        return _ssd.ssd_chunk(x, dt, A, B_, C_)
    return ref.ssd_chunk_plain(x, dt, A, B_, C_)


def launch_counts() -> dict[str, int]:
    """Kernel launches so far, by kernel, as the kernels counted them on
    the card (a replayed CUDA graph's launches included); synchronizes
    the devices.  ``*_combine``: the decode kernels' split-combine
    launches; ``flash_decode_lse``: B3's launches with the log-sum-exp;
    ``flash_attention_offset``: B2's launches at a query offset > 0."""
    pd, fd = _fd.paged_decode.counter.read(), _fd.flash_decode.counter.read()
    fa = _fa.flash_attention.counter.read()
    return {"paged_decode": pd["launches"],
            "paged_decode_combine": pd["combines"],
            "flash_decode": fd["launches"],
            "flash_decode_combine": fd["combines"],
            "flash_decode_lse": fd["lse_launches"],
            "flash_attention": fa["launches"],
            "flash_attention_offset": fa["offset_launches"],
            "flash_attention_bwd":
                _fab.flash_attention_bwd.counter["launches"],
            "ssd_chunk": _ssd.ssd_chunk.counter["launches"],
            "ssd_chunk_bwd": _ssb.ssd_chunk_bwd.counter["launches"]}


def reset_launch_counts() -> None:
    for fn in (_fd.paged_decode, _fd.flash_decode, _fa.flash_attention,
               _fab.flash_attention_bwd, _ssd.ssd_chunk, _ssb.ssd_chunk_bwd):
        fn.counter.reset()
