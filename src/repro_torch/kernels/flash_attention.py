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
and to itself.  Its plain version is ``ref.flash_attention_ref``;
``ops.flash_attention`` picks between them by the tensors' device.

With ``with_lse`` the kernel also writes each row's log-sum-exp, which the
backward (``flash_attention_bwd``) recomputes P from; the training path of
``ops.flash_attention`` asks for it, serving does not.

``flash_attention.launches`` counts the kernel launches this process made,
``flash_attention.offset_launches`` those of them with ``q_offset > 0``
(a chunk, or the resumed prefill of a prefix-cache hit).
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
        fn.argtypes = [i, p, p, p, p, p, i, i, i, i, i, i, i, i, i, f, f, p]
        fn.restype = ctypes.c_int
    return lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, softcap: float = 0.0,
                    window: int = 0, q_offset: int = 0,
                    with_lse: bool = False):
    """Launch the prefill kernel on CUDA tensors.

    q: [B, Sq, Hq, D]; k/v: [B, Sk, Hkv, D]; fp32 or bf16, D in
    ``HEAD_DIMS``; query row i at position ``q_offset + i``.  Scores are
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
    if q_offset < 0:
        raise ValueError(f"q_offset {q_offset} < 0")
    dev = q.device
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
        Hq, Hkv, D, int(q_offset), int(causal), int(window), float(softcap),
        float(scale), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    flash_attention.launches += 1
    flash_attention.offset_launches += q_offset > 0
    return (out, lse) if with_lse else out


flash_attention.launches = 0
flash_attention.offset_launches = 0
