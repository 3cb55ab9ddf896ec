"""Shared building blocks: norms, softcap, rotary and sinusoidal positions,
MLPs.

Numerics follow the JAX package exactly: RMSNorm computes in fp32 and
scales by ``(1 + w)``; RoPE is split-half (not interleaved) with fp32
angles; sinusoidal embeddings are ``[sin | cos]`` of fp32 angles; GELU is
the tanh approximation.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + weight.float())).to(dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if cap <= 0.0:
        return x
    return cap * torch.tanh(x / cap)


# -- positions ---------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


_FREQS: dict = {}


def _rope_freqs_on(d: int, theta: float, device) -> torch.Tensor:
    """``rope_freqs`` as fp32 on ``device``, copied there once: a copy
    from host memory cannot sit inside a captured CUDA graph, and the
    first, eager run of every graphed step fills this cache."""
    key = (d, theta, torch.device(device))
    if key not in _FREQS:
        _FREQS[key] = torch.as_tensor(rope_freqs(d, theta),
                                      dtype=torch.float32, device=device)
    return _FREQS[key]


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [B, S, H, D]; positions: [B, S]."""
    freqs = _rope_freqs_on(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs          # [B, S, D/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sincos_embedding(positions: torch.Tensor, d_model: int) -> torch.Tensor:
    """Absolute sinusoidal embeddings (opt, musicgen): positions [B, S] ->
    [B, S, d_model] fp32, ``[sin | cos]`` of ``pos * freq`` with the
    frequencies ``exp(-log(1e4) * i / half)``, computed in fp32 in the JAX
    package's order."""
    half = d_model // 2
    i = torch.arange(half, dtype=torch.float32, device=positions.device)
    freqs = torch.exp(-math.log(10_000.0) * i / half)
    angles = positions[..., None].float() * freqs
    return torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1)


# -- MLPs ---------------------------------------------------------------------


def mlp(x: torch.Tensor, p: dict, variant: str) -> torch.Tensor:
    """x: [B, S, d_model] -> [B, S, d_model]."""
    up = x @ p["w_up"]
    if "b_up" in p:
        up = up + p["b_up"]
    if variant == "swiglu":
        h = F.silu(x @ p["w_gate"]) * up
    elif variant == "geglu":
        h = F.gelu(x @ p["w_gate"], approximate="tanh") * up
    else:
        h = F.gelu(up, approximate="tanh")
    out = h @ p["w_down"]
    if "b_down" in p:
        out = out + p["b_down"]
    return out
