"""Mamba2 / SSD (state-space duality) mixer, plus the hybrid (hymba) path.

The port of the JAX package's ``models/ssm.py``.  Train/prefill runs the
chunked SSD (Dao & Gu, 2024): the within-chunk quadratic form goes through
``ops.ssd_chunk`` (the hand-written kernel on CUDA tensors, its plain
version on the CPU); the cross-chunk recurrence over per-chunk states
[B, H, P, N] is a Python loop over chunks, in place of JAX's
``associative_scan`` (a 1024-token prompt has 4 chunks of 256).  Decode
keeps a constant-size recurrent state and updates it in plain torch, as the
JAX package does in jnp.

All scan math runs in fp32; projections stay in the weights' dtype, and
the causal conv sums in fp32 and rounds its result to that dtype.  The functions take one layer's parameter views; the
layer-stacked init is ``init_ssm``.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig

# leaves kept in fp32 whatever the weights' dtype, as in the JAX package
FP32_KEYS = ("dt_bias", "A_log", "D")


def conv_channels(cfg: ModelConfig) -> int:
    return cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state


def init_ssm(cfg: ModelConfig, normal, dtype, device) -> dict:
    """Layer-stacked SSM weights: the JAX package's keys, shapes, scales and
    deterministic leaves, with ``normal(shape, std)`` drawing the random
    ones.  Per-stream projections (z, x, B, C, dt) stay separate."""
    L, d = cfg.n_layers, cfg.d_model
    H, N, G, W = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_groups, \
        cfg.ssm_conv_width
    d_inner = cfg.d_inner
    s = 1.0 / math.sqrt(d)
    f32 = dict(dtype=torch.float32, device=device)
    # softplus^-1 of linspace(1e-3, 1e-1, H), in float64 and rounded once:
    # the JAX package computes it in fp32, whose linspace, exp and log
    # round differently in the last bit, so the two agree to a few ulps
    lin = np.linspace(1e-3, 1e-1, H)
    dt_bias = torch.as_tensor(np.log(np.exp(lin) - 1.0), **f32)
    return {
        "w_z": normal((L, d, d_inner), s),
        "w_x": normal((L, d, d_inner), s),
        "w_B": normal((L, d, G * N), s),
        "w_C": normal((L, d, G * N), s),
        "w_dt": normal((L, d, H), s),
        "conv_x": normal((L, W, d_inner), 0.2),
        "conv_B": normal((L, W, G * N), 0.2),
        "conv_C": normal((L, W, G * N), 0.2),
        "conv_b": torch.zeros((L, conv_channels(cfg)), dtype=dtype,
                              device=device),
        "dt_bias": dt_bias.expand(L, H).contiguous(),
        "A_log": torch.zeros((L, H), **f32),    # A = -exp(A_log) = -1
        "D": torch.ones((L, H), **f32),
        "norm_w": torch.zeros((L, d_inner), dtype=dtype, device=device),
        "out_proj": normal((L, d_inner, d), 1.0 / math.sqrt(d_inner)),
    }


def _project(x: torch.Tensor, p: dict):
    """x [..., d] -> (z, xs, B, C, dt) per-stream projections."""
    return (x @ p["w_z"], x @ p["w_x"], x @ p["w_B"], x @ p["w_C"],
            x @ p["w_dt"])


def _conv_weight(p: dict) -> torch.Tensor:
    return torch.cat([p["conv_x"], p["conv_B"], p["conv_C"]], dim=-1)


def causal_conv(stream: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                init: torch.Tensor):
    """Causal depthwise conv of ``stream`` [B, L, C] continuing the window
    ``init`` [B, W - 1, C] of earlier inputs, with weights ``w`` [W, C] and
    bias ``b`` [C].  Returns (silu(conv + b) [B, L, C], the new window
    [B, W - 1, C]).

    The products and their sum are fp32 and rounded once to the stream's
    dtype, the arithmetic of the JAX package's decode einsum.  Prefill
    and decode both call this, so in bf16 a decoded token's conv output is
    bit for bit the one a prefill over the same tokens gives it.
    """
    L, W = stream.shape[1], w.shape[0]
    padded = torch.cat([init, stream], dim=1)
    pf, wf = padded.float(), w.float()
    out = pf[:, :L] * wf[0]
    for i in range(1, W):
        out = out + pf[:, i:i + L] * wf[i]
    # the window is copied: a view would keep all of ``padded`` alive for
    # as long as the caller keeps the window (prefill keeps every layer's)
    return F.silu(out.to(stream.dtype) + b), padded[:, L:].clone()


def _gated_norm(y: torch.Tensor, z: torch.Tensor, w: torch.Tensor,
                eps: float) -> torch.Tensor:
    y = y * F.silu(z.float())
    var = torch.mean(y * y, dim=-1, keepdim=True)
    return y * torch.rsqrt(var + eps) * (1.0 + w.float())


def ssd_chunked(xs, dt, A, B_, C_, chunk: int, init_state=None):
    """Chunked SSD scan.

    Args:
      xs: [B, L, H, P] inputs (post-conv, activated), fp32.
      dt: [B, L, H] softplus'd step sizes, fp32.
      A:  [H] negative decay rates, fp32.
      B_, C_: [B, L, G, N] input/output projections, fp32.
      chunk: the chunk length; Q = min(chunk, L) and L is zero-padded to a
        multiple of Q with dt = 0 (decay 1, no input), which leaves the
        real rows and the final state unchanged.
      init_state: optional [B, H, P, N] initial state.
    Returns:
      (y [B, L, H, P], final_state [B, H, P, N])
    """
    Bsz, L, H, P = xs.shape
    G, N = B_.shape[2], B_.shape[3]
    Q = min(chunk, max(L, 1))
    pad = (-L) % Q
    if pad:
        xs = F.pad(xs, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B_ = F.pad(B_, (0, 0, 0, 0, 0, pad))
        C_ = F.pad(C_, (0, 0, 0, 0, 0, pad))
    Nc = (L + pad) // Q
    rep = H // G
    xs_c = xs.reshape(Bsz, Nc, Q, H, P).contiguous()
    dt_c = dt.reshape(Bsz, Nc, Q, H).contiguous()
    B_c = B_.reshape(Bsz, Nc, Q, G, N).contiguous()
    C_c = C_.reshape(Bsz, Nc, Q, G, N).contiguous()

    # within-chunk: the kernel (groups resolved inside it)
    y_intra, S_chunk = ops.ssd_chunk(xs_c, dt_c, A.contiguous(), B_c, C_c)

    # across chunks: state entering chunk c, then state' = state * a + S_c
    cs = torch.cumsum(dt_c * A, dim=2)                  # [B, Nc, Q, H]
    a_tot = torch.exp(cs[:, :, -1])                     # [B, Nc, H]
    state = (torch.zeros((Bsz, H, P, N), dtype=torch.float32,
                         device=xs.device)
             if init_state is None else init_state.float())
    prev = []
    for c in range(Nc):
        prev.append(state)
        state = state * a_tot[:, c, :, None, None] + S_chunk[:, c]
    S_prev = torch.stack(prev, dim=1).reshape(Bsz, Nc, G, rep, P, N)

    # inter-chunk contribution: y_t += exp(cs_t) * C_t . S_prev
    y_inter = torch.einsum("bcqgn,bcgrpn->bcqgrp", C_c, S_prev)
    y_inter = y_inter * torch.exp(cs).reshape(Bsz, Nc, Q, G, rep)[..., None]
    y = y_intra + y_inter.reshape(Bsz, Nc, Q, H, P)
    return y.reshape(Bsz, Nc * Q, H, P)[:, :L], state


def ssm_forward(x: torch.Tensor, p: dict, cfg: ModelConfig,
                init_state: torch.Tensor | None = None,
                conv_init: torch.Tensor | None = None):
    """Full-sequence SSD mixer.

    Args:
      x: [B, L, d_model].
    Returns: (out [B, L, d_model], final_ssm_state [B, H, P, N] fp32,
              final_conv_window [B, W - 1, conv_channels])
    """
    Bsz, L, _ = x.shape
    H, P = cfg.ssm_heads, cfg.ssm_head_dim
    G, N = cfg.ssm_groups, cfg.ssm_state
    W = cfg.ssm_conv_width
    d_inner = cfg.d_inner
    splits = [d_inner, G * N, G * N]

    z, xs, B_, C_, dt = _project(x, p)
    if conv_init is None:
        conv_init = torch.zeros((Bsz, W - 1, conv_channels(cfg)),
                                dtype=xs.dtype, device=x.device)
    # the conv is depthwise, so the three streams go through it as one
    conv, new_conv_window = causal_conv(
        torch.cat([xs, B_, C_], dim=-1), _conv_weight(p), p["conv_b"],
        conv_init.to(xs.dtype))
    xs_c, B_c, C_c = torch.split(conv, splits, dim=-1)

    xs_f = xs_c.reshape(Bsz, L, H, P).float()
    B_f = B_c.reshape(Bsz, L, G, N).float()
    C_f = C_c.reshape(Bsz, L, G, N).float()
    dt_f = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])

    y, state = ssd_chunked(xs_f, dt_f, A, B_f, C_f, cfg.ssm_chunk,
                           init_state)
    y = y + xs_f * p["D"][None, None, :, None]
    y = y.reshape(Bsz, L, H * P)
    y = _gated_norm(y, z, p["norm_w"], cfg.norm_eps)
    out = y.to(x.dtype) @ p["out_proj"]
    return out, state, new_conv_window


def ssm_decode_step(x: torch.Tensor, p: dict, cfg: ModelConfig,
                    state: torch.Tensor, conv_window: torch.Tensor):
    """One recurrent step.

    Args:
      x: [B, 1, d_model]; state: [B, H, P, N] fp32;
      conv_window: [B, W - 1, conv_channels] (previous conv inputs).
    Returns: (out [B, 1, d_model], new state, new conv window); the inputs
      are not modified.
    """
    Bsz = x.shape[0]
    H, P = cfg.ssm_heads, cfg.ssm_head_dim
    G, N = cfg.ssm_groups, cfg.ssm_state

    z, xs, B_, C_, dt = _project(x[:, 0], p)
    conv_in = torch.cat([xs, B_, C_], dim=-1)               # [B, conv_ch]
    conv, new_window = causal_conv(conv_in[:, None], _conv_weight(p),
                                   p["conv_b"],
                                   conv_window.to(conv_in.dtype))
    xs_c, B_c, C_c = torch.split(conv[:, 0], [H * P, G * N, G * N], dim=-1)

    xs_f = xs_c.reshape(Bsz, H, P).float()
    B_f = torch.repeat_interleave(B_c.reshape(Bsz, G, N), H // G,
                                  dim=1).float()
    C_f = torch.repeat_interleave(C_c.reshape(Bsz, G, N), H // G,
                                  dim=1).float()
    dt_f = F.softplus(dt.float() + p["dt_bias"])            # [B, H]
    A = -torch.exp(p["A_log"])
    a = torch.exp(dt_f * A)                                 # [B, H]

    state = (state * a[..., None, None]
             + (dt_f[..., None] * xs_f)[..., None] * B_f[:, :, None, :])
    y = torch.einsum("bhn,bhpn->bhp", C_f, state)
    y = y + xs_f * p["D"][None, :, None]
    y = y.reshape(Bsz, H * P)
    y = _gated_norm(y, z, p["norm_w"], cfg.norm_eps)
    out = (y.to(x.dtype) @ p["out_proj"])[:, None]
    return out, state, new_window
