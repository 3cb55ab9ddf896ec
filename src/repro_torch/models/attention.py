"""Grouped-query attention: full-sequence prefill and paged decode.

Both paths go through ``kernels.ops``: on CUDA tensors the hand-written
kernels run, on CPU tensors their plain PyTorch versions.  GQA is resolved
inside the kernels (query head h reads KV head h // group); no expanded
K/V copy is made.  The paged decode writes the new token's K/V into the
pool *in place* (``index_put_``) — the JAX package's functional
``.at[].set`` pool update becomes a mutation of the caller's pool tensors.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_rope, rms_norm


def _project_qkv(x: torch.Tensor, p: dict, cfg: ModelConfig,
                 positions: torch.Tensor):
    B, S, _ = x.shape
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, cfg.n_q_heads, cfg.head_dim)
    k = k.reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if cfg.pos_embedding == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def full_attention(x: torch.Tensor, p: dict, cfg: ModelConfig,
                   positions: torch.Tensor, is_local: bool = False):
    """Train/prefill self-attention over the whole sequence.

    Returns (out [B, S, d_model], k, v [B, S, Hkv, D]); prefill caches the
    projected k and v.  ``is_local`` selects gemma2's sliding-window mask
    for this layer.
    """
    B, S, _ = x.shape
    q, k, v = _project_qkv(x, p, cfg, positions)
    window = cfg.local_window if is_local else 0
    out = ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                              causal=True,
                              softcap=float(cfg.attn_logit_softcap),
                              window=window)
    return out.reshape(B, S, cfg.q_dim) @ p["wo"], k, v


def paged_decode_attention(x: torch.Tensor, p: dict, cfg: ModelConfig,
                           k_pages: torch.Tensor, v_pages: torch.Tensor,
                           block_table: torch.Tensor, lens: torch.Tensor,
                           is_local: bool = False) -> torch.Tensor:
    """One decode step against one layer's paged KV pool, scatter first.

    Args:
      x: [B, 1, d_model] current token embedding.
      k_pages / v_pages: [P, Hkv, page, D] one layer's pool (kernel-native
        layout).  The new K/V token is written into its page IN PLACE.
      block_table: [B, n_pages] int32 physical page ids (padded rows point
        at the trash page, so their writes land there harmlessly).
      lens: [B] int32 tokens already cached; the new token is written at
        position ``lens`` and attention covers [start, lens + 1).
    Returns: attn_out [B, 1, d_model].
    """
    B = x.shape[0]
    pos = lens
    q, k_new, v_new = _project_qkv(x, p, cfg, pos[:, None])
    page = k_pages.shape[2]
    Hkv = k_pages.shape[1]
    n_pages = block_table.shape[1]
    rows = torch.arange(B, device=x.device)
    # the column clamp matches the JAX gather's index clamping; it only
    # matters for trash rows, whose table row is all trash page anyway
    col = torch.clamp(pos.long() // page, max=n_pages - 1)
    pid = block_table[rows, col].long()                   # [B]
    off = (pos % page).long()
    hidx = torch.arange(Hkv, device=x.device)[None, :]
    k_pages.index_put_((pid[:, None], hidx, off[:, None]),
                       k_new[:, 0].to(k_pages.dtype))
    v_pages.index_put_((pid[:, None], hidx, off[:, None]),
                       v_new[:, 0].to(v_pages.dtype))

    len_att = pos + 1
    if cfg.local_window > 0 and is_local:
        start = torch.clamp(len_att - cfg.local_window, min=0)
    else:
        start = torch.zeros_like(len_att)
    out = ops.paged_decode(q[:, 0].to(k_pages.dtype).contiguous(), k_pages,
                           v_pages, block_table, len_att.to(torch.int32),
                           start.to(torch.int32),
                           softcap=float(cfg.attn_logit_softcap))
    out = out.to(x.dtype).reshape(B, 1, cfg.q_dim)
    return out @ p["wo"]
