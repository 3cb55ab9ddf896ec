"""Shared building blocks: norms, softcap, rotary positions, MLPs.

Numerics follow the JAX package exactly: RMSNorm computes in fp32 and
scales by ``(1 + w)``; RoPE is split-half (not interleaved) with fp32
angles; GELU is the tanh approximation.
"""
from __future__ import annotations

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


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [B, S, H, D]; positions: [B, S]."""
    d = x.shape[-1]
    freqs = torch.as_tensor(rope_freqs(d, theta), dtype=torch.float32,
                            device=x.device)
    angles = positions[..., None].float() * freqs          # [B, S, D/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


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
