"""Causal prefill attention: the wrapper around ``csrc/flash_attention.cu``.

Replaces the Pallas TPU kernel ``_kernel``/``flash_attention`` of the JAX
package.  In bf16, the serving dtype, the kernel runs on the tensor cores
(``mma.sync`` m16n8k16, fp32 accumulation; K/V tiles kept bf16 in shared
memory behind a two-stage ``cp.async`` ring); P is rounded to bf16 before
P·V, as the JAX package's ``full_attention`` rounds it.  fp32 runs the
first, CUDA-core version, for the card's fp32 parity checks.  GQA is
resolved inside the kernel (query head h reads KV head h // group) and
ragged Sq / Sk are masked there, so nothing is padded or expanded here.
``q_offset`` places query row i at position q_offset + i for the causal
and window masks: a prefill chunk attends to the resident tokens before it
and to itself.  It is a host int (the by-value form) or an int32 tensor on
the card, one scalar or one offset per batch row (the device-offset form:
the kernel reads it, so a captured CUDA graph serves any offset written
into the tensor before a replay; both forms compute the same bits).  Its
plain version is ``ref.flash_attention_ref``; ``ops.flash_attention``
picks between them by the tensors' device.

With ``with_lse`` the kernel also writes each row's log-sum-exp, which the
backward (``flash_attention_bwd``) recomputes P from; the training path of
``ops.flash_attention`` asks for it, serving does not.

``flash_attention.counter`` (``build.LaunchCounter``) holds the counts
the kernel keeps on the card: its launches, and those of them at a query
offset > 0 (a chunk, or the resumed prefill of a prefix-cache hit), which
the kernel tells from the offset it reads, by value or from the device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import DTYPE_CODES, HEAD_DIMS, check_tensor


def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    fn = lib.flash_attention
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [i, p, p, p, p, p, i, i, i, i, i, i, i, p, i, i, i, f,
                       f, p, p]
        fn.restype = ctypes.c_int
    return lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, softcap: float = 0.0,
                    window: int = 0, q_offset: int | torch.Tensor = 0,
                    with_lse: bool = False):
    """Launch the prefill kernel on CUDA tensors.

    q: [B, Sq, Hq, D]; k/v: [B, Sk, Hkv, D]; fp32 or bf16, D in
    ``HEAD_DIMS``; query row i at position ``q_offset + i``, ``q_offset``
    a host int or an int32 tensor on q's device holding one offset or B
    (the device-offset form: the offset must be >= 0).  Scores are
    scaled by 1/sqrt(D).  Returns out [B, Sq, Hq, D] in q's dtype, and with
    ``with_lse`` also each row's log-sum-exp lse [B, Hq, Sq] fp32 (what
    the backward kernel recomputes P from).
    """
    if not q.is_cuda:
        raise ValueError("flash_attention launches a CUDA kernel; "
                         "use ops.flash_attention for CPU tensors")
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"unsupported dtype {q.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {HEAD_DIMS}")
    if Hq % Hkv:
        raise ValueError(f"{Hq} query heads do not group over {Hkv} KV heads")
    dev = q.device
    off_ptr, off_stride = None, 0
    if isinstance(q_offset, torch.Tensor):
        if q_offset.numel() not in (1, B):
            raise ValueError(f"a device q_offset holds 1 or B = {B} offsets, "
                             f"not {q_offset.numel()}")
        check_tensor("q_offset", q_offset, dev, torch.int32,
                     tuple(q_offset.shape))
        off_ptr, off_stride = q_offset.data_ptr(), int(q_offset.numel() > 1)
        host_offset = 0
    elif q_offset < 0:
        raise ValueError(f"q_offset {q_offset} < 0")
    else:
        host_offset = int(q_offset)
    check_tensor("q", q, dev, q.dtype, (B, Sq, Hq, D))
    check_tensor("k", k, dev, q.dtype, (B, Sk, Hkv, D))
    check_tensor("v", v, dev, q.dtype, (B, Sk, Hkv, D))
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    scale = 1.0 / (D ** 0.5)
    out = torch.empty_like(q)
    lse = (torch.empty((B, Hq, Sq), dtype=torch.float32, device=dev)
           if with_lse else None)
    if B == 0 or Sq == 0:
        return (out, lse) if with_lse else out
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib().flash_attention(
        DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), None if lse is None else lse.data_ptr(), B, Sq, Sk,
        Hq, Hkv, D, host_offset, off_ptr, off_stride, int(causal),
        int(window), float(softcap), float(scale),
        flash_attention.counter.ptr(dev), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    return (out, lse) if with_lse else out


flash_attention.counter = build.LaunchCounter("launches", "offset_launches")
