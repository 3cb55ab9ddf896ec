"""Grouped-query attention: full-sequence prefill, chunked prefill into
the paged pool, and decode against the paged pool or a dense cache.

Every path goes through ``kernels.ops``: on CUDA tensors the hand-written
kernels run, on CPU tensors their plain PyTorch versions.  GQA is resolved
inside the kernels (query head h reads KV head h // group); no expanded
K/V copy is made.  The decode and chunk paths write the new K/V into the
pool or cache *in place* (``index_put_``) — the JAX package's functional
``.at[].set`` update becomes a mutation of the caller's tensors.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops, ref
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


def write_pages(k_pages: torch.Tensor, v_pages: torch.Tensor,
                pages: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                ) -> None:
    """A one-shot prefill's K/V written into its pages IN PLACE.

    k_pages / v_pages: [P, Hkv, page, D] one layer's pool; pages [B, n]
    int32 page ids, n = ceil(S / page), distinct; k / v [B, S, Hkv, D].
    Whole pages are written, the last one's tail past S with zeros, as the
    JAX package's ``write_prefill`` pads.  The ids are read on the device
    only."""
    B, S, Hkv, D = k.shape
    page = k_pages.shape[2]
    n = pages.shape[1]
    pad = (0, 0, 0, 0, 0, n * page - S)
    idx = pages.long()
    for pool, new in ((k_pages, k), (v_pages, v)):
        blocks = torch.nn.functional.pad(new, pad).reshape(
            B, n, page, Hkv, D).transpose(2, 3)          # [B, n, Hkv, page, D]
        pool.index_put_((idx,), blocks.to(pool.dtype))


def _decode_window(pos: torch.Tensor, cfg: ModelConfig, is_local: bool):
    """(lens, start) int32 of a decode step writing at ``pos``: it attends
    to [start, pos + 1), the last ``local_window`` positions on a local
    layer."""
    len_att = pos + 1
    if cfg.local_window > 0 and is_local:
        start = torch.clamp(len_att - cfg.local_window, min=0)
    else:
        start = torch.zeros_like(len_att)
    return len_att.to(torch.int32), start.to(torch.int32)


def prefill_chunk_attention(x: torch.Tensor, p: dict, cfg: ModelConfig,
                            k_pages: torch.Tensor, v_pages: torch.Tensor,
                            block_table: torch.Tensor,
                            start: int | torch.Tensor,
                            n_valid: int | torch.Tensor, trash_page: int,
                            is_local: bool = False) -> torch.Tensor:
    """One prefill *chunk* attending the paged prefix and itself.

    Args:
      x: [B, C, d_model] chunk embeddings at positions ``start + [0, C)``
        (every sequence of the batch shares ``start``).
      k_pages / v_pages: [P, Hkv, page, D] one layer's pool.  The chunk's
        K/V is written into its pages IN PLACE; the bucketed tail past
        ``n_valid`` goes to ``trash_page``.
      block_table: [B, n_pages] int32 page ids covering ``start + C``.
      start: tokens already resident (earlier chunks); n_valid: real
        tokens in this chunk.  Ints, or int32 device scalars: positions,
        the valid mask, the page ids and the prefill kernel's query offset
        (its device-offset form) are then all made on the device.
    Returns: attn_out [B, C, d_model] (rows past ``n_valid`` are junk).
    """
    B, C = x.shape[0], x.shape[1]
    pos = start + torch.arange(C, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project_qkv(x, p, cfg, pos[None, :])
    page = k_pages.shape[2]
    Hkv = k_pages.shape[1]
    n_pages = block_table.shape[1]
    valid = torch.arange(C, device=x.device) < n_valid
    col = torch.clamp(pos.long() // page, max=n_pages - 1)
    pid = torch.where(valid[None, :], block_table[:, col].long(),
                      trash_page)                               # [B, C]
    off = (pos % page).long()[None, :, None]
    hidx = torch.arange(Hkv, device=x.device)[None, None, :]
    k_pages.index_put_((pid[:, :, None], hidx, off), k_new.to(k_pages.dtype))
    v_pages.index_put_((pid[:, :, None], hidx, off), v_new.to(v_pages.dtype))

    # the prefix and the chunk, gathered through the table (positions past
    # the chunk are masked by the causal limit)
    k, v = ref.gather_pages_dense(k_pages, v_pages, block_table)
    window = cfg.local_window if is_local else 0
    out = ops.flash_attention(q.contiguous(), k.to(q.dtype).contiguous(),
                              v.to(q.dtype).contiguous(), causal=True,
                              softcap=float(cfg.attn_logit_softcap),
                              window=window, q_offset=start)
    return out.reshape(B, C, cfg.q_dim) @ p["wo"]


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

    len_att, start = _decode_window(pos, cfg, is_local)
    out = ops.paged_decode(q[:, 0].to(k_pages.dtype).contiguous(), k_pages,
                           v_pages, block_table, len_att, start,
                           softcap=float(cfg.attn_logit_softcap))
    out = out.to(x.dtype).reshape(B, 1, cfg.q_dim)
    return out @ p["wo"]


def decode_attention(x: torch.Tensor, p: dict, cfg: ModelConfig,
                     k_cache: torch.Tensor, v_cache: torch.Tensor,
                     pos: torch.Tensor, is_local: bool = False
                     ) -> torch.Tensor:
    """One decode step against one layer's dense cache, scatter first.

    Args:
      x: [B, 1, d_model] current token embedding.
      k_cache / v_cache: [B, S, Hkv, D] one layer's dense cache (contiguous);
        the new K/V is written at ``pos`` IN PLACE.
      pos: [B] int32 write position; attention covers [start, pos + 1).
    Returns: attn_out [B, 1, d_model].
    """
    B = x.shape[0]
    q, k_new, v_new = _project_qkv(x, p, cfg, pos[:, None])
    rows = torch.arange(B, device=x.device)
    k_cache.index_put_((rows, pos.long()), k_new[:, 0].to(k_cache.dtype))
    v_cache.index_put_((rows, pos.long()), v_new[:, 0].to(v_cache.dtype))
    lens, start = _decode_window(pos, cfg, is_local)
    out = ops.flash_decode(q[:, 0].to(k_cache.dtype).contiguous(), k_cache,
                           v_cache, lens, start,
                           softcap=float(cfg.attn_logit_softcap))
    out = out.to(x.dtype).reshape(B, 1, cfg.q_dim)
    return out @ p["wo"]
