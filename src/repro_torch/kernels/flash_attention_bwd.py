"""Backward of the causal prefill attention: the wrapper around
``csrc/flash_attention_bwd.cu``.

Replaces no TPU kernel: the JAX package differentiates its plain
``full_attention`` with XLA's autodiff and has no backward kernel; this is
the port's counterpart of that autodiff for the prefill kernel
(``flash_attention``).  From q, k, v, the forward's out and its per-row
log-sum-exp, and dO, three launches (delta = rowsum(dO * O); dK and dV a
key tile at a time over the group's query heads; dQ a query tile at a time)
give dq, dk, dv with no atomics, so the same inputs give the same bits.
Causal mask, window and softcap as the forward, GQA summed over the group,
ragged Sq / Sk; queries at positions 0.. (training has no query offset).
bf16 at D <= 128 runs on the tensor cores (``mma.sync``); fp32 and bf16 at
D = 256 on the CUDA cores.
Its plain version is ``ref.flash_attention_bwd_plain``;
``ops.flash_attention`` calls this from its ``autograd.Function``.

``flash_attention_bwd.counter`` (``build.LaunchCounter``) holds the calls
the kernels count on the card (one call, three kernel launches: the
first counts).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import DTYPE_CODES, HEAD_DIMS, check_tensor


def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention_bwd")
    fn = lib.flash_attention_bwd
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [i, p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i,
                       i, f, f, p, p]
        fn.restype = ctypes.c_int
    return lib


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, dout: torch.Tensor,
                        lse: torch.Tensor, *, causal: bool = True,
                        softcap: float = 0.0, window: int = 0,
                        q_offset: int = 0
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the backward kernels on CUDA tensors.

    q, out, dout: [B, Sq, Hq, D]; k/v: [B, Sk, Hkv, D]; fp32 or bf16, D in
    ``HEAD_DIMS``; lse: [B, Hq, Sq] fp32 from the forward.  Returns (dq, dk,
    dv) in q's dtype.  Only ``q_offset = 0`` is taken.
    """
    if not q.is_cuda:
        raise ValueError("flash_attention_bwd launches a CUDA kernel; use "
                         "ref.flash_attention_bwd_plain for CPU tensors")
    if q_offset != 0:
        raise ValueError(f"flash_attention_bwd takes no query offset "
                         f"(got {q_offset})")
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"unsupported dtype {q.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {HEAD_DIMS}")
    if Hq % Hkv:
        raise ValueError(f"{Hq} query heads do not group over {Hkv} KV heads")
    dev = q.device
    check_tensor("q", q, dev, q.dtype, (B, Sq, Hq, D))
    check_tensor("k", k, dev, q.dtype, (B, Sk, Hkv, D))
    check_tensor("v", v, dev, q.dtype, (B, Sk, Hkv, D))
    check_tensor("out", out, dev, q.dtype, (B, Sq, Hq, D))
    check_tensor("dout", dout, dev, q.dtype, (B, Sq, Hq, D))
    check_tensor("lse", lse, dev, torch.float32, (B, Hq, Sq))
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out),
                    ("dout", dout)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if B == 0 or Sq == 0 or Sk == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    delta = torch.empty((B, Hq, Sq), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib().flash_attention_bwd(
        DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, Sq, Sk, Hq, Hkv, D,
        int(causal), int(window), float(softcap), 1.0 / (D ** 0.5),
        flash_attention_bwd.counter.ptr(dev), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: CUDA "
                           f"error {err}")
    return dq, dk, dv


flash_attention_bwd.counter = build.LaunchCounter("launches")
