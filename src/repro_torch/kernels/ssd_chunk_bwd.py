"""Backward of the SSD (Mamba2) within-chunk kernel: the wrapper around
``csrc/ssd_chunk_bwd.cu``.

Replaces no TPU kernel: the JAX package differentiates its plain
``ssd_chunked`` (``src/repro/models/ssm.py:70``) with XLA's autodiff and
has no backward kernel; this is the port's counterpart of that autodiff
for the SSD chunk kernel (``ssd_scan.ssd_chunk``).  From the forward's
inputs x, dt, A, B, C and the gradients dy of y and dS of the chunk
states it gives dx, ddt, dA, dB and dC in fp32.  Operations bound it on
the card, so every product runs on the tensor cores in 3xTF32 (one TF32
pass would miss the 1e-4 row limit: ``tests/test_torch_ssd_bwd_tf32.py``)
and each is formed once: C.B^T once a block of heads, dy.x^T once a head,
dB and dC once a group on dCB summed over the group's heads first.  Three
launches (the state's terms, which the second takes itself where N <= 32;
the 64-column tiles of each chunk and head block; ddt and dA a head at a
time beside dB and dC a group at a time), no atomics, so the same inputs
give the same bits.  Shape limits as the forward's
(``ssd_scan.check_inputs``; ragged Q masked inside).  An input need only
be contiguous, not 16-byte aligned (unaligned rows are staged with 4-byte
copies).  Its plain version is ``ref.ssd_chunk_bwd_plain``;
``ops.ssd_chunk`` calls this from its ``autograd.Function``.

``ssd_chunk_bwd.counter`` (``build.LaunchCounter``) holds the calls the
kernels count on the card (one call, two or three kernel launches: the
tile launch, which every call makes, counts).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import check_tensor
from repro_torch.kernels.ssd_scan import check_inputs


def _lib() -> ctypes.CDLL:
    lib = build.load("ssd_chunk_bwd")
    fn = lib.ssd_chunk_bwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 13 + [i] * 6 + [p, p]
        fn.restype = ctypes.c_int
        ws = lib.ssd_chunk_bwd_workspace
        ws.argtypes = [i] * 4
        ws.restype = ctypes.c_int64
    return lib


def ssd_chunk_bwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  B_: torch.Tensor, C_: torch.Tensor, dy: torch.Tensor,
                  dS: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor, torch.Tensor]:
    """Launch the backward kernels on CUDA tensors.

    x, dy: [B, Nc, Q, H, P]; dt: [B, Nc, Q, H]; A: [H];
    B_/C_: [B, Nc, Q, G, N]; dS: [B, Nc, H, P, N]; all fp32 and
    contiguous.  Returns (dx, ddt, dA, dB, dC), dB and dC per group.
    """
    if not x.is_cuda:
        raise ValueError("ssd_chunk_bwd launches a CUDA kernel; use "
                         "ref.ssd_chunk_bwd_plain for CPU tensors")
    Bsz, Nc, Q, H, P, G, N = check_inputs(x, dt, A, B_, C_)
    dev, f32 = x.device, torch.float32
    check_tensor("dy", dy, dev, f32, (Bsz, Nc, Q, H, P))
    check_tensor("dS", dS, dev, f32, (Bsz, Nc, H, P, N))
    dx, ddt = torch.empty_like(x), torch.empty_like(dt)
    dB, dC = torch.empty_like(B_), torch.empty_like(C_)
    dA = torch.empty_like(A)
    BNc = Bsz * Nc
    if BNc == 0 or H == 0:
        return dx, ddt, dA.zero_(), dB, dC
    lib = _lib()
    ws = torch.empty(lib.ssd_chunk_bwd_workspace(BNc, Q, H, N), dtype=f32,
                     device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.ssd_chunk_bwd(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B_.data_ptr(),
        C_.data_ptr(), dy.data_ptr(), dS.data_ptr(), dx.data_ptr(),
        ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(), dC.data_ptr(),
        ws.data_ptr(), BNc, Q, H, G, P, N, ssd_chunk_bwd.counter.ptr(dev),
        stream)
    if err != 0:
        raise RuntimeError(f"ssd_chunk_bwd kernel launch failed: CUDA error "
                           f"{err}")
    return dx, ddt, dA, dB, dC


ssd_chunk_bwd.counter = build.LaunchCounter("launches")
