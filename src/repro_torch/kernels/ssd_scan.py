"""SSD (Mamba2) within-chunk kernel: the wrapper around ``csrc/ssd_chunk.cu``.

Replaces the Pallas TPU kernel ``_ssd_kernel``/``ssd_chunk`` of the JAX
package.  B and C are taken per group and head h reads group
h // (H // G) inside the kernel, so nothing is broadcast to heads here; a
ragged chunk length Q is masked inside the kernel, so nothing is padded
either.  Its plain version is ``ref.ssd_chunk_plain``; ``ops.ssd_chunk``
picks between them by the tensors' device.

``ssd_chunk.launches`` counts the kernel launches this process made.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import check_tensor

HEAD_DIMS = (16, 32, 64, 128)
MAX_STATE = 256
MAX_CHUNK = 1024


def _lib() -> ctypes.CDLL:
    lib = build.load("ssd_chunk")
    fn = lib.ssd_chunk
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return lib


def ssd_chunk(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
              B_: torch.Tensor, C_: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the SSD chunk kernel on CUDA tensors.

    x: [B, Nc, Q, H, P]; dt: [B, Nc, Q, H]; A: [H]; B_/C_: [B, Nc, Q, G, N];
    all fp32.  P in ``HEAD_DIMS``, N <= ``MAX_STATE``, Q <= ``MAX_CHUNK``,
    H a multiple of G.  Returns (y [B, Nc, Q, H, P], S [B, Nc, H, P, N]).
    """
    if not x.is_cuda:
        raise ValueError("ssd_chunk launches a CUDA kernel; "
                         "use ops.ssd_chunk for CPU tensors")
    Bsz, Nc, Q, H, P = x.shape
    G, N = B_.shape[3], B_.shape[4]
    if P not in HEAD_DIMS:
        raise ValueError(f"ssm head_dim {P} not in {HEAD_DIMS}")
    if not 1 <= N <= MAX_STATE:
        raise ValueError(f"ssm state {N} not in [1, {MAX_STATE}]")
    if not 1 <= Q <= MAX_CHUNK:
        raise ValueError(f"chunk length {Q} not in [1, {MAX_CHUNK}]")
    if G < 1 or H % G:
        raise ValueError(f"{H} heads do not group over {G} groups")
    dev, f32 = x.device, torch.float32
    check_tensor("x", x, dev, f32, (Bsz, Nc, Q, H, P))
    check_tensor("dt", dt, dev, f32, (Bsz, Nc, Q, H))
    check_tensor("A", A, dev, f32, (H,))
    check_tensor("B_", B_, dev, f32, (Bsz, Nc, Q, G, N))
    check_tensor("C_", C_, dev, f32, (Bsz, Nc, Q, G, N))
    y = torch.empty_like(x)
    S = torch.empty((Bsz, Nc, H, P, N), dtype=f32, device=dev)
    if Bsz * Nc == 0 or H == 0:
        return y, S
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib().ssd_chunk(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B_.data_ptr(),
        C_.data_ptr(), y.data_ptr(), S.data_ptr(), Bsz * Nc, Q, H, G, P, N,
        stream)
    if err != 0:
        raise RuntimeError(f"ssd_chunk kernel launch failed: CUDA error "
                           f"{err}")
    ssd_chunk.launches += 1
    return y, S


ssd_chunk.launches = 0
