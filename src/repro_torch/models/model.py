"""The decoder-only model of the port: attention-only dense architectures.

Parameters are a plain dict with the JAX package's keys and layout: layers
stacked on axis 0 under ``blocks`` (``blocks["attn"]["wq"]`` is
[L, d_model, q_dim]), weights as ``x @ w`` matrices.  PyTorch runs eagerly,
so the JAX layer ``scan`` is a Python loop over layer views.

Entry points:
  init_params(cfg, seed, dtype, device)        -> parameter dict
  forward(params, cfg, tokens)                 -> logits [B, S, Vpad]
  prefill(params, cfg, tokens)                 -> (logits [B, Vpad], k, v)
  decode_step_paged(params, cfg, tokens, st)   -> (logits, state)
  decode_loop_paged(params, cfg, tokens, st, horizon)
      -> ([B, horizon] tokens on the device, state)

MoE and SSM layers are not ported yet; configs that need them raise.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.models import attention as attn_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import mlp, rms_norm, softcap
from repro_torch.models.sampling import sample, step_generator


@dataclasses.dataclass
class PagedDecodeState:
    """Device-resident paged decode state.

    ``k``/``v`` are the pools [L, P, Hkv, page, D] in kernel-native layout;
    decode steps write them in place.
    """
    k: torch.Tensor
    v: torch.Tensor
    block_table: torch.Tensor   # [B, n_pages] int32 physical page ids
    lens: torch.Tensor          # [B] int32 tokens already cached


def check_supported(cfg: ModelConfig) -> None:
    if cfg.is_moe:
        raise NotImplementedError(
            f"{cfg.name}: MoE layers are not ported yet "
            "(ROADMAP.md Queue A item 7, models/moe.py)")
    if cfg.has_ssm or not cfg.has_attn:
        raise NotImplementedError(
            f"{cfg.name}: SSM layers are not ported yet "
            "(ROADMAP.md Queue A item 8, models/ssm.py)")
    if cfg.pos_embedding not in ("rope", "none"):
        raise NotImplementedError(
            f"{cfg.name}: {cfg.pos_embedding} positions are not ported yet "
            "(ROADMAP.md Queue A item 2)")


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

    Same keys, shapes and scales as the JAX package's ``init_params``; the
    values differ (JAX keys cannot be reproduced in torch).
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
    attn = {"wq": normal((L, d, q_dim), s), "wk": normal((L, d, kv_dim), s),
            "wv": normal((L, d, kv_dim), s),
            "wo": normal((L, q_dim, d), 1.0 / math.sqrt(q_dim))}
    if cfg.qkv_bias:
        attn.update(bq=zeros(L, q_dim), bk=zeros(L, kv_dim),
                    bv=zeros(L, kv_dim))
    if cfg.qk_norm:
        attn.update(q_norm=zeros(L, cfg.head_dim),
                    k_norm=zeros(L, cfg.head_dim))
    blocks: dict = {"ln1": zeros(L, d), "attn": attn}
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


def _block(x, bp, cfg: ModelConfig, layer: int, positions):
    """Full-sequence block: attention + dense MLP with residuals."""
    h = rms_norm(x, bp["ln1"], cfg.norm_eps)
    mix = attn_lib.full_attention(h, bp["attn"], cfg, positions,
                                  cfg.local_is_local(layer))
    return _mlp_residual(_mix_residual(x, mix, bp, cfg), bp, cfg)


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
        x = _block(x, layer_params(params["blocks"], layer), cfg, layer,
                   positions)
    return lm_logits(params, cfg, x)


def prefill(params, cfg: ModelConfig, tokens: torch.Tensor):
    """One-shot prefill of same-length prompts.

    tokens [B, S] -> (last-token logits [B, Vpad] fp32,
    k [L, B, S, Hkv, D], v [L, B, S, Hkv, D]).
    """
    check_supported(cfg)
    B, S = tokens.shape
    positions = _positions(B, S, tokens.device)
    x = embed_inputs(params, cfg, tokens)
    ks, vs = [], []
    for layer in range(cfg.n_layers):
        bp = layer_params(params["blocks"], layer)
        h = rms_norm(x, bp["ln1"], cfg.norm_eps)
        q, k, v = attn_lib._project_qkv(h, bp["attn"], cfg, positions)
        ks.append(k)
        vs.append(v)
        mix = attn_lib.attend_full(q, k, v, bp["attn"], cfg,
                                   cfg.local_is_local(layer))
        x = _mlp_residual(_mix_residual(x, mix, bp, cfg), bp, cfg)
    logits = lm_logits(params, cfg, x[:, -1:, :])[:, 0]
    return logits, torch.stack(ks), torch.stack(vs)


# --------------------------------------------------------------------------
# Paged decode.
# --------------------------------------------------------------------------


def decode_step_paged(params, cfg: ModelConfig, tokens: torch.Tensor,
                      state: PagedDecodeState):
    """One token for every sequence, attending the paged pool directly.

    tokens [B] int32.  Each layer's new K/V token is written into its page
    in place and attention reads pages through the block table.
    Returns (logits [B, Vpad] fp32, state with lens + 1).
    """
    check_supported(cfg)
    x = embed_inputs(params, cfg, tokens[:, None])
    for layer in range(cfg.n_layers):
        bp = layer_params(params["blocks"], layer)
        h = rms_norm(x, bp["ln1"], cfg.norm_eps)
        mix = attn_lib.paged_decode_attention(
            h, bp["attn"], cfg, state.k[layer], state.v[layer],
            state.block_table, state.lens, cfg.local_is_local(layer))
        x = _mlp_residual(_mix_residual(x, mix, bp, cfg), bp, cfg)
    logits = lm_logits(params, cfg, x)[:, 0]
    return logits, dataclasses.replace(state, lens=state.lens + 1)


def decode_loop_paged(params, cfg: ModelConfig, tokens: torch.Tensor,
                      state: PagedDecodeState, horizon: int, *,
                      temperature: float = 0.0, seed: int = 0,
                      step0: int = 0):
    """``horizon`` decode steps with the tokens kept on the device.

    The scatter-first loop: each step writes its K/V token into the pool,
    attends, samples and feeds the token straight back.  Nothing here
    reads a value back to the host; the caller makes one transfer of the
    returned [B, horizon] block per horizon.  Page capacity for
    ``horizon`` more tokens per sequence must already be in the block
    table.  With ``temperature > 0`` step ``step0 + i`` samples from
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
