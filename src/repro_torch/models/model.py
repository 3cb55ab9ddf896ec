"""The decoder-only model of the port: dense attention, SSD (mamba2) and
hybrid parallel attention + SSD (hymba) layers.

Parameters are a plain dict with the JAX package's keys and layout: layers
stacked on axis 0 under ``blocks`` (``blocks["attn"]["wq"]`` is
[L, d_model, q_dim], ``blocks["ssm"]["w_x"]`` [L, d_model, d_inner]),
weights as ``x @ w`` matrices.  PyTorch runs eagerly, so the JAX layer
``scan`` is a Python loop over layer views.

Entry points:
  init_params(cfg, seed, dtype, device)        -> parameter dict
  forward(params, cfg, tokens)                 -> logits [B, S, Vpad]
  prefill(params, cfg, tokens)                 -> (logits [B, Vpad],
                                                   PrefillCache)
  prefill_chunk(params, cfg, tokens, k, v, table, start, n_valid, trash)
      -> logits [B, Vpad] at position start + n_valid - 1
  decode_step(params, cfg, tokens, cache)      -> (logits, DecodeCache)
  decode_step_paged(params, cfg, tokens, st)   -> (logits, state)
  decode_loop_paged(params, cfg, tokens, st, horizon)
      -> ([B, horizon] tokens on the device, state)

MoE layers are not ported yet; configs that need them raise.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.models import attention as attn_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import mlp, rms_norm, softcap
from repro_torch.models.sampling import sample, step_generator


@dataclasses.dataclass
class PrefillCache:
    """What one-shot prefill leaves for decode, per layer (None where the
    architecture has no such state)."""
    k: torch.Tensor | None      # [L, B, S, Hkv, D]
    v: torch.Tensor | None
    ssm: torch.Tensor | None    # [L, B, H, P, N] fp32 final SSM state
    conv: torch.Tensor | None   # [L, B, W - 1, conv_ch] last conv inputs


@dataclasses.dataclass
class DecodeCache:
    """A dense decode cache (the engine's ``decode_mode="dense"``): per
    layer, each sequence's K/V at positions [0, S) (None where the
    architecture has no such state).  ``decode_step`` writes all four in
    place."""
    k: torch.Tensor | None      # [L, B, S, Hkv, D] contiguous
    v: torch.Tensor | None
    ssm: torch.Tensor | None    # [L, B, H, P, N] fp32
    conv: torch.Tensor | None   # [L, B, W - 1, conv_ch]
    pos: torch.Tensor           # [B] int32 tokens already in the cache


@dataclasses.dataclass
class PagedDecodeState:
    """Device-resident paged decode state.

    ``k``/``v`` are the pools [L, P, Hkv, page, D] in kernel-native layout
    (None for an attention-free model); ``ssm``/``conv`` are the batch's
    SSM state and conv window rows (None without SSM layers).  Decode steps
    write all four in place.
    """
    k: torch.Tensor | None
    v: torch.Tensor | None
    block_table: torch.Tensor   # [B, n_pages] int32 physical page ids
    lens: torch.Tensor          # [B] int32 tokens already cached
    ssm: torch.Tensor | None = None     # [L, B, H, P, N] fp32
    conv: torch.Tensor | None = None    # [L, B, W - 1, conv_ch]


def check_supported(cfg: ModelConfig) -> None:
    if cfg.is_moe:
        raise NotImplementedError(
            f"{cfg.name}: MoE layers are not ported yet "
            "(ROADMAP.md Queue A item 5, models/moe.py)")
    if cfg.pos_embedding not in ("rope", "none"):
        raise NotImplementedError(
            f"{cfg.name}: {cfg.pos_embedding} positions are not ported yet "
            "(ROADMAP.md Queue A item 5)")


# --------------------------------------------------------------------------
# Parameter init.
# --------------------------------------------------------------------------


def _normal(shape, std: float, gen: torch.Generator, dtype, device
            ) -> torch.Tensor:
    """N(0, std) in ``dtype``, drawn layer by layer for stacked weights so
    no full-size fp32 temporary is ever made."""
    t = torch.empty(shape, dtype=dtype, device=device)
    for part in (t if len(shape) == 3 else [t]):
        part.normal_(0.0, std, generator=gen)
    return t


def init_params(cfg: ModelConfig, seed: int = 0, dtype=torch.bfloat16,
                device="cuda") -> dict:
    """Random weights from a ``torch.Generator`` seeded with ``seed``, made
    on ``device``.

    Same keys, shapes, scales and dtypes as the JAX package's
    ``init_params`` (the SSM's ``dt_bias``/``A_log``/``D`` stay fp32); the
    random values differ (JAX keys cannot be reproduced in torch).
    """
    check_supported(cfg)
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    L, d, V = cfg.n_layers, cfg.d_model, cfg.padded_vocab()
    q_dim, kv_dim, f = cfg.q_dim, cfg.kv_dim, cfg.d_ff

    def normal(shape, std):
        return _normal(shape, std, generator, dtype, device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    s = 1.0 / math.sqrt(d)
    blocks: dict = {"ln1": zeros(L, d)}
    if cfg.has_attn:
        attn = {"wq": normal((L, d, q_dim), s),
                "wk": normal((L, d, kv_dim), s),
                "wv": normal((L, d, kv_dim), s),
                "wo": normal((L, q_dim, d), 1.0 / math.sqrt(q_dim))}
        if cfg.qkv_bias:
            attn.update(bq=zeros(L, q_dim), bk=zeros(L, kv_dim),
                        bv=zeros(L, kv_dim))
        if cfg.qk_norm:
            attn.update(q_norm=zeros(L, cfg.head_dim),
                        k_norm=zeros(L, cfg.head_dim))
        blocks["attn"] = attn
    if cfg.has_ssm:
        blocks["ssm"] = ssm_lib.init_ssm(cfg, normal, dtype, device)
    if cfg.hybrid:
        blocks["attn_out_norm"] = zeros(L, d)
        blocks["ssm_out_norm"] = zeros(L, d)
    if cfg.sandwich_norm:
        blocks["post_ln1"] = zeros(L, d)
    if f > 0:
        m = {}
        if cfg.mlp_variant in ("swiglu", "geglu"):
            m["w_gate"] = normal((L, d, f), s)
        m["w_up"] = normal((L, d, f), s)
        m["w_down"] = normal((L, f, d), 1.0 / math.sqrt(f))
        if cfg.mlp_bias:
            m.update(b_up=zeros(L, f), b_down=zeros(L, d))
        blocks["ln2"] = zeros(L, d)
        blocks["mlp"] = m
        if cfg.sandwich_norm:
            blocks["post_ln2"] = zeros(L, d)
    params = {"embed": normal((V, d), 0.02), "blocks": blocks,
              "final_norm": zeros(d)}
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((d, V), 0.02)
    return params


def param_count(params) -> int:
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    return params.numel()


def layer_params(blocks: dict, layer: int) -> dict:
    """The views of one layer's weights in the layer-stacked ``blocks``."""
    return {k: layer_params(v, layer) if isinstance(v, dict) else v[layer]
            for k, v in blocks.items()}


# --------------------------------------------------------------------------
# Block application.
# --------------------------------------------------------------------------


def _mlp_residual(x, bp, cfg: ModelConfig):
    if cfg.d_ff > 0:
        m = mlp(rms_norm(x, bp["ln2"], cfg.norm_eps), bp["mlp"],
                cfg.mlp_variant)
        if cfg.sandwich_norm:
            m = rms_norm(m, bp["post_ln2"], cfg.norm_eps)
        x = x + m
    return x


def _mix_residual(x, mix, bp, cfg: ModelConfig):
    if cfg.sandwich_norm:
        mix = rms_norm(mix, bp["post_ln1"], cfg.norm_eps)
    return x + mix


def _combine(attn_out, ssm_out, bp, cfg: ModelConfig):
    """The mixer output: attention, SSM, or hymba's normalised average."""
    if cfg.hybrid:
        return 0.5 * (rms_norm(attn_out, bp["attn_out_norm"], cfg.norm_eps)
                      + rms_norm(ssm_out, bp["ssm_out_norm"], cfg.norm_eps))
    return attn_out if cfg.has_attn else ssm_out


def _block(x, bp, cfg: ModelConfig, layer: int, positions):
    """Full-sequence block: attention and/or SSD mixer + dense MLP with
    residuals.  Returns (x, per-layer PrefillCache entries k, v, ssm, conv).
    """
    h = rms_norm(x, bp["ln1"], cfg.norm_eps)
    attn_out = ssm_out = k = v = state = conv = None
    if cfg.has_attn:
        attn_out, k, v = attn_lib.full_attention(
            h, bp["attn"], cfg, positions, cfg.local_is_local(layer))
    if cfg.has_ssm:
        ssm_out, state, conv = ssm_lib.ssm_forward(h, bp["ssm"], cfg)
    mix = _combine(attn_out, ssm_out, bp, cfg)
    x = _mlp_residual(_mix_residual(x, mix, bp, cfg), bp, cfg)
    return x, (k, v, state, conv)


# --------------------------------------------------------------------------
# Embedding & head.
# --------------------------------------------------------------------------


def embed_inputs(params, cfg: ModelConfig, tokens: torch.Tensor):
    x = params["embed"][tokens.long()]
    if cfg.scale_embedding:
        x = x * np.sqrt(cfg.d_model)
    return x


def lm_logits(params, cfg: ModelConfig, x):
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = (x @ head).float()
    return softcap(logits, cfg.final_logit_softcap)


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device).expand(B, S)


# --------------------------------------------------------------------------
# Full-sequence forward and prefill.
# --------------------------------------------------------------------------


def forward(params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    """tokens [B, S] -> logits [B, S, padded_vocab] (fp32)."""
    check_supported(cfg)
    B, S = tokens.shape
    positions = _positions(B, S, tokens.device)
    x = embed_inputs(params, cfg, tokens)
    for layer in range(cfg.n_layers):
        x, _ = _block(x, layer_params(params["blocks"], layer), cfg, layer,
                      positions)
    return lm_logits(params, cfg, x)


def prefill(params, cfg: ModelConfig, tokens: torch.Tensor):
    """One-shot prefill of same-length prompts.

    tokens [B, S] -> (last-token logits [B, Vpad] fp32, PrefillCache with
    k/v [L, B, S, Hkv, D], the final SSM state [L, B, H, P, N] and the conv
    window [L, B, W - 1, conv_ch], each None where the model has none).
    """
    check_supported(cfg)
    B, S = tokens.shape
    positions = _positions(B, S, tokens.device)
    x = embed_inputs(params, cfg, tokens)
    per_layer = []
    for layer in range(cfg.n_layers):
        x, caches = _block(x, layer_params(params["blocks"], layer), cfg,
                           layer, positions)
        per_layer.append(caches)
    logits = lm_logits(params, cfg, x[:, -1:, :])[:, 0]
    stacked = [None if parts[0] is None else torch.stack(parts)
               for parts in zip(*per_layer)]
    return logits, PrefillCache(*stacked)


def prefill_chunk(params, cfg: ModelConfig, tokens: torch.Tensor,
                  k: torch.Tensor, v: torch.Tensor, block_table: torch.Tensor,
                  start: int, n_valid: int, trash_page: int) -> torch.Tensor:
    """One *chunk* of a paged prefill: positions ``start + [0, C)``.

    tokens [B, C] int32, every sequence at the same ``start``; only the
    first ``n_valid`` positions are real (the bucketed tail writes to
    ``trash_page``).  Each layer writes the chunk's K/V into the pools
    k/v [L, P, Hkv, page, D] in place and attends to the earlier chunks
    through ``block_table`` [B, n_pages] (pages covering ``start + C``).
    Returns the logits at position ``start + n_valid - 1`` [B, Vpad] fp32.
    Models with SSM layers raise, as in the JAX package: the SSD scan has
    no per-position state to resume a bucketed chunk from.
    """
    check_supported(cfg)
    if cfg.has_ssm:
        raise NotImplementedError(
            "chunked prefill supports attention-only models")
    x = embed_inputs(params, cfg, tokens)
    for layer in range(cfg.n_layers):
        bp = layer_params(params["blocks"], layer)
        h = rms_norm(x, bp["ln1"], cfg.norm_eps)
        mix = attn_lib.prefill_chunk_attention(
            h, bp["attn"], cfg, k[layer], v[layer], block_table, start,
            n_valid, trash_page, cfg.local_is_local(layer))
        x = _mlp_residual(_mix_residual(x, mix, bp, cfg), bp, cfg)
    return lm_logits(params, cfg, x[:, n_valid - 1:n_valid])[:, 0]


# --------------------------------------------------------------------------
# Decode.
# --------------------------------------------------------------------------


def _decode_core(params, cfg: ModelConfig, tokens: torch.Tensor, attend,
                 ssm: torch.Tensor | None, conv: torch.Tensor | None):
    """The decode-step body shared by the dense and paged caches: embed,
    the layers, logits.  ``attend(h, p, layer)`` is one layer's attention;
    the SSM rows ssm/conv [L, B, ...] are updated in place.
    Returns logits [B, Vpad] fp32."""
    check_supported(cfg)
    x = embed_inputs(params, cfg, tokens[:, None])
    for layer in range(cfg.n_layers):
        bp = layer_params(params["blocks"], layer)
        h = rms_norm(x, bp["ln1"], cfg.norm_eps)
        attn_out = ssm_out = None
        if cfg.has_attn:
            attn_out = attend(h, bp["attn"], layer)
        if cfg.has_ssm:
            ssm_out, new_state, new_conv = ssm_lib.ssm_decode_step(
                h, bp["ssm"], cfg, ssm[layer], conv[layer])
            ssm[layer] = new_state
            conv[layer] = new_conv
        mix = _combine(attn_out, ssm_out, bp, cfg)
        x = _mlp_residual(_mix_residual(x, mix, bp, cfg), bp, cfg)
    return lm_logits(params, cfg, x)[:, 0]


def decode_step(params, cfg: ModelConfig, tokens: torch.Tensor,
                cache: DecodeCache):
    """One token for every sequence against a dense cache.

    tokens [B] int32.  Each layer writes its new K/V at ``cache.pos`` and
    its SSM rows in place, then attends to [start, pos + 1).
    Returns (logits [B, Vpad] fp32, cache with pos + 1).
    """
    def attend(h, p, layer):
        return attn_lib.decode_attention(
            h, p, cfg, cache.k[layer], cache.v[layer], cache.pos,
            cfg.local_is_local(layer))

    logits = _decode_core(params, cfg, tokens, attend, cache.ssm, cache.conv)
    return logits, dataclasses.replace(cache, pos=cache.pos + 1)


def decode_step_paged(params, cfg: ModelConfig, tokens: torch.Tensor,
                      state: PagedDecodeState):
    """One token for every sequence, attending the paged pool directly.

    tokens [B] int32.  Each layer's new K/V token is written into its page
    in place and attention reads pages through the block table; each SSM
    layer's state and conv window rows are updated in place.
    Returns (logits [B, Vpad] fp32, state with lens + 1).
    """
    def attend(h, p, layer):
        return attn_lib.paged_decode_attention(
            h, p, cfg, state.k[layer], state.v[layer], state.block_table,
            state.lens, cfg.local_is_local(layer))

    logits = _decode_core(params, cfg, tokens, attend, state.ssm, state.conv)
    return logits, dataclasses.replace(state, lens=state.lens + 1)


def decode_loop_paged(params, cfg: ModelConfig, tokens: torch.Tensor,
                      state: PagedDecodeState, horizon: int, *,
                      temperature: float = 0.0, seed: int = 0,
                      step0: int = 0):
    """``horizon`` decode steps with the tokens kept on the device.

    The scatter-first loop: each step writes its K/V token into the pool
    and its SSM rows in place, attends, samples and feeds the token straight
    back.  Nothing here reads a value back to the host; the caller makes
    one transfer of the returned [B, horizon] block per horizon.  Page
    capacity for ``horizon`` more tokens per sequence must already be in
    the block table.  With ``temperature > 0`` step ``step0 + i`` samples from
    ``step_generator(seed, step0 + i)``, so sampled streams do not depend
    on the horizon.
    Returns (tokens [B, horizon] int32, state with lens + horizon).
    """
    out = []
    for i in range(horizon):
        logits, state = decode_step_paged(params, cfg, tokens, state)
        gen = (step_generator(seed, step0 + i, tokens.device)
               if temperature > 0 else None)
        tokens = sample(logits, cfg, gen, temperature=temperature)
        out.append(tokens)
    return torch.stack(out, dim=1), state
