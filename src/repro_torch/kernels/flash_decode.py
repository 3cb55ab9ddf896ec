"""Paged decode attention: the wrapper around ``csrc/paged_decode.cu``.

Replaces the Pallas TPU kernel ``_paged_kernel``/``_paged_call`` of the JAX
package (entry ``flash_decode_paged_native``).  The kernel runs one CTA per
(sequence, KV head) serving all of the group's query heads, so every live
page crosses device memory once per KV head; it is bound by those bytes
(see the note at the top of the CUDA source).  Its plain version is
``ref.paged_decode_plain``; ``ops.paged_decode`` picks between them by the
tensors' device.

``paged_decode.launches`` counts the kernel launches this process made.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import DTYPE_CODES, HEAD_DIMS, check_tensor


def _lib() -> ctypes.CDLL:
    lib = build.load("paged_decode")
    fn = lib.paged_decode
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [i, p, p, p, p, p, p, p, i, i, i, i, i, i, f, f, p]
        fn.restype = ctypes.c_int
    return lib


def paged_decode(q: torch.Tensor, k_pages: torch.Tensor,
                 v_pages: torch.Tensor, block_table: torch.Tensor,
                 lens: torch.Tensor, start: torch.Tensor, softcap: float,
                 scale: float) -> torch.Tensor:
    """Launch the paged-decode kernel on CUDA tensors.

    q: [B, Hq, D]; k_pages/v_pages: [P, Hkv, page, D]; block_table:
    [B, n_pages] int32; lens/start: [B] int32.  fp32 or bf16 (q and pools
    alike), D in ``HEAD_DIMS``.  Returns [B, Hq, D] in q's dtype.
    """
    if not q.is_cuda:
        raise ValueError("paged_decode launches a CUDA kernel; "
                         "use ops.paged_decode for CPU tensors")
    B, Hq, D = q.shape
    P, Hkv, page, _ = k_pages.shape
    n_pages = block_table.shape[1]
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"unsupported dtype {q.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {HEAD_DIMS}")
    if Hq % Hkv:
        raise ValueError(f"{Hq} query heads do not group over {Hkv} KV heads")
    dev = q.device
    check_tensor("q", q, dev, q.dtype, (B, Hq, D))
    check_tensor("k_pages", k_pages, dev, q.dtype, (P, Hkv, page, D))
    check_tensor("v_pages", v_pages, dev, q.dtype, (P, Hkv, page, D))
    check_tensor("block_table", block_table, dev, torch.int32, (B, n_pages))
    check_tensor("lens", lens, dev, torch.int32, (B,))
    check_tensor("start", start, dev, torch.int32, (B,))
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    out = torch.empty_like(q)
    if B == 0:
        return out
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib().paged_decode(
        DTYPE_CODES[q.dtype], q.data_ptr(), k_pages.data_ptr(),
        v_pages.data_ptr(), block_table.data_ptr(), lens.data_ptr(),
        start.data_ptr(), out.data_ptr(), B, Hq, Hkv, page, D, n_pages,
        float(softcap), float(scale), stream)
    if err != 0:
        raise RuntimeError(f"paged_decode kernel launch failed: CUDA error "
                           f"{err}")
    paged_decode.launches += 1
    return out


paged_decode.launches = 0
