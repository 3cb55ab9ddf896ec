"""The decoder-only model of the port, covering every family of the JAX
package: dense GQA attention (with gemma2's local/global alternation,
softcaps and sandwich norms, biases, qk-norm, RoPE or sinusoidal
positions), MoE MLPs, SSD mixers (mamba2) and hybrid parallel attention +
SSD heads (hymba).  The VLM/audio archs use the same backbone; their
modality frontends are stubs, so ``forward``, ``prefill`` and the decode
steps also take precomputed embeddings (``embeds=``) in place of ids.

Parameters are a plain dict with the JAX package's keys and layout: layers
stacked on axis 0 under ``blocks`` (``blocks["attn"]["wq"]`` is
[L, d_model, q_dim], ``blocks["ssm"]["w_x"]`` [L, d_model, d_inner]),
weights as ``x @ w`` matrices.  PyTorch runs eagerly, so the JAX layer
``scan`` is a Python loop over layer views.

Entry points:
  init_params(cfg, seed, dtype, device)        -> parameter dict
  forward(params, cfg, tokens|embeds)          -> logits [B, S, Vpad]
      (pos_offset=, remat= and with_aux= as the JAX package's, for the
      trainer)
  prefill(params, cfg, tokens|embeds)          -> (logits [B, Vpad],
                                                   PrefillCache)
  prefill_paged(params, cfg, tokens, k, v, pages, ssm, conv, slots)
      -> logits [B, Vpad], the caches written into the engine's pool
  prefill_chunk(params, cfg, tokens, k, v, table, start, n_valid, trash)
      -> logits [B, Vpad] at position start + n_valid - 1
  decode_step(params, cfg, tokens, cache)      -> (logits, DecodeCache)
  decode_step_paged(params, cfg, tokens, st)   -> (logits, state)
  decode_loop_paged(params, cfg, tokens, st, horizon)
      -> ([B, horizon] tokens on the device, state)

Every path embeds at the true positions (sinusoidal models add them to
the embeddings): ``arange(S)`` in forward and prefill, ``start + arange(C)``
in a chunk, the cache's ``pos`` or the paged state's ``lens`` in decode.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import mlp, rms_norm, sincos_embedding, softcap
from repro_torch.models.sampling import sample_step


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


# --------------------------------------------------------------------------
# Parameter init.
# --------------------------------------------------------------------------


def _normal(shape, std: float, gen: torch.Generator, dtype, device
            ) -> torch.Tensor:
    """N(0, std) in ``dtype``, drawn one matrix at a time for stacked
    weights (a layer's, or a layer's expert's) so no full-size fp32
    temporary is ever made."""
    t = torch.empty(shape, dtype=dtype, device=device)
    for part in (t.view(-1, *shape[-2:]) if len(shape) >= 3 else [t]):
        part.normal_(0.0, std, generator=gen)
    return t


def init_params(cfg: ModelConfig, seed: int = 0, dtype=torch.bfloat16,
                device="cuda") -> dict:
    """Random weights from a ``torch.Generator`` seeded with ``seed``, made
    on ``device``.

    Same keys, shapes, scales and dtypes as the JAX package's
    ``init_params`` (the SSM's ``dt_bias``/``A_log``/``D`` and the MoE
    router stay fp32); the random values differ (JAX keys cannot be
    reproduced in torch).
    """
    # the meta device (shapes only: ``launch.sharding.param_shapes``) draws
    # from a CPU generator
    generator = torch.Generator(
        device="cpu" if torch.device(device).type == "meta" else device)
    generator.manual_seed(seed)
    L, d, V = cfg.n_layers, cfg.d_model, cfg.padded_vocab()
    q_dim, kv_dim, f = cfg.q_dim, cfg.kv_dim, cfg.d_ff

    def normal(shape, std, dtype=dtype):
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
    if cfg.is_moe:
        blocks["ln2"] = zeros(L, d)
        blocks["moe"] = moe_lib.init_moe(cfg, normal)
    elif f > 0:
        m = {}
        if cfg.mlp_variant in ("swiglu", "geglu"):
            m["w_gate"] = normal((L, d, f), s)
        m["w_up"] = normal((L, d, f), s)
        m["w_down"] = normal((L, f, d), 1.0 / math.sqrt(f))
        if cfg.mlp_bias:
            m.update(b_up=zeros(L, f), b_down=zeros(L, d))
        blocks["ln2"] = zeros(L, d)
        blocks["mlp"] = m
    if cfg.sandwich_norm and (cfg.is_moe or f > 0):
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


def _mlp_residual(x, bp, cfg: ModelConfig, aux: list | None = None):
    """x + the layer's MLP or MoE; a MoE layer appends its load-balance loss
    of the MoE input to ``aux`` when one is given."""
    if cfg.is_moe or cfg.d_ff > 0:
        h = rms_norm(x, bp["ln2"], cfg.norm_eps)
        if cfg.is_moe:
            m = moe_lib.moe_block(h, bp["moe"], cfg)
        else:
            m = mlp(h, bp["mlp"], cfg.mlp_variant)
        if cfg.is_moe and aux is not None:
            aux.append(moe_lib.load_balance_loss(h, bp["moe"], cfg))
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


def _block(x, bp, cfg: ModelConfig, layer: int, positions,
           aux: list | None = None):
    """Full-sequence block: attention and/or SSD mixer + dense or MoE MLP
    with residuals.  Returns (x, per-layer PrefillCache entries k, v, ssm,
    conv); a MoE layer appends its load-balance loss to ``aux`` if given.
    """
    h = rms_norm(x, bp["ln1"], cfg.norm_eps)
    attn_out = ssm_out = k = v = state = conv = None
    if cfg.has_attn:
        attn_out, k, v = attn_lib.full_attention(
            h, bp["attn"], cfg, positions, cfg.local_is_local(layer))
    if cfg.has_ssm:
        ssm_out, state, conv = ssm_lib.ssm_forward(h, bp["ssm"], cfg)
    mix = _combine(attn_out, ssm_out, bp, cfg)
    x = _mlp_residual(_mix_residual(x, mix, bp, cfg), bp, cfg, aux)
    return x, (k, v, state, conv)


# --------------------------------------------------------------------------
# Embedding & head.
# --------------------------------------------------------------------------


def embed_inputs(params, cfg: ModelConfig, tokens=None, embeds=None,
                 positions=None):
    """Token ids [B, S] (or precomputed embeddings [B, S, d] for the
    stub-frontend archs) at ``positions`` [B, S] -> [B, S, d]."""
    if embeds is None:
        x = params["embed"][tokens.long()]
    else:
        x = embeds.to(params["embed"].dtype)
    if cfg.scale_embedding:
        x = x * np.sqrt(cfg.d_model)
    if cfg.pos_embedding == "sincos":
        x = x + sincos_embedding(positions, cfg.d_model).to(x.dtype)
    return x


def lm_logits(params, cfg: ModelConfig, x):
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = (x @ head).float()
    return softcap(logits, cfg.final_logit_softcap)


def _positions(B: int, S: int, device, start: int | torch.Tensor = 0
               ) -> torch.Tensor:
    """[B, S] int32 positions ``start + arange(S)``; ``start`` an int or
    an int32 device scalar (the chunk graph's, read on the device)."""
    return (torch.arange(S, dtype=torch.int32, device=device)
            + start).expand(B, S)


def _last_row(x: torch.Tensor, n_valid: int | torch.Tensor) -> torch.Tensor:
    """x[:, n_valid - 1:n_valid] [B, 1, d]; a device ``n_valid`` is taken
    by an index op, which reads nothing back to the host."""
    if isinstance(n_valid, torch.Tensor):
        return x.index_select(1, (n_valid - 1).reshape(1).long())
    return x[:, n_valid - 1:n_valid]


def _shape(tokens, embeds):
    """(B, S, device) of the ids [B, S] or the embeddings [B, S, d]."""
    t = tokens if tokens is not None else embeds
    return t.shape[0], t.shape[1], t.device


# --------------------------------------------------------------------------
# Full-sequence forward and prefill.
# --------------------------------------------------------------------------


def forward(params, cfg: ModelConfig, tokens: torch.Tensor | None = None,
            embeds: torch.Tensor | None = None, pos_offset: int = 0,
            remat: bool = False, with_aux: bool = False):
    """tokens [B, S] (or embeds [B, S, d]) at positions ``pos_offset +
    arange(S)`` -> logits [B, S, padded_vocab] (fp32); (logits, aux) if
    ``with_aux``, aux being the MoE layers' load-balance losses summed over
    the layers and divided by ``n_layers`` (0 without MoE).

    ``remat`` recomputes each layer's activations in the backward pass
    (``torch.utils.checkpoint``, non-reentrant), as the JAX package's
    ``jax.checkpoint`` around its layer body does.
    """
    B, S, device = _shape(tokens, embeds)
    positions = _positions(B, S, device, pos_offset)
    x = embed_inputs(params, cfg, tokens, embeds, positions)
    aux_sum = torch.zeros((), dtype=torch.float32, device=device)
    for layer in range(cfg.n_layers):
        bp = layer_params(params["blocks"], layer)

        def body(x, bp=bp, layer=layer):
            aux = []
            x, _ = _block(x, bp, cfg, layer, positions, aux)
            return x, (aux[0] if aux else torch.zeros_like(aux_sum))

        if remat:
            x, aux = torch.utils.checkpoint.checkpoint(
                body, x, use_reentrant=False)
        else:
            x, aux = body(x)
        aux_sum = aux_sum + aux
    logits = lm_logits(params, cfg, x)
    if with_aux:
        return logits, aux_sum / cfg.n_layers
    return logits


def _prefill_layers(params, cfg: ModelConfig, tokens, embeds, keep
                    ) -> torch.Tensor:
    """The one-shot prefill's forward: each layer's caches (k, v, ssm,
    conv; None where the model has none) go to ``keep(layer, caches)`` as
    the layer ends, so nothing holds them past it.  Returns the last
    token's logits [B, Vpad] fp32."""
    B, S, device = _shape(tokens, embeds)
    positions = _positions(B, S, device)
    x = embed_inputs(params, cfg, tokens, embeds, positions)
    for layer in range(cfg.n_layers):
        x, caches = _block(x, layer_params(params["blocks"], layer), cfg,
                           layer, positions)
        keep(layer, caches)
    return lm_logits(params, cfg, x[:, -1:, :])[:, 0]


def prefill(params, cfg: ModelConfig, tokens: torch.Tensor | None = None,
            embeds: torch.Tensor | None = None):
    """One-shot prefill of same-length prompts.

    tokens [B, S] (or embeds [B, S, d]) -> (last-token logits [B, Vpad]
    fp32, PrefillCache with k/v [L, B, S, Hkv, D], the final SSM state
    [L, B, H, P, N] and the conv window [L, B, W - 1, conv_ch], each None
    where the model has none).
    """
    # each layer's caches go straight into the layer-stacked tensors, so a
    # layer's own copy is freed with it (no list of L copies to stack)
    stacked = [None] * 4

    def keep(layer, caches):
        for i, c in enumerate(caches):
            if c is not None:
                if stacked[i] is None:
                    stacked[i] = c.new_empty((cfg.n_layers, *c.shape))
                stacked[i][layer] = c

    logits = _prefill_layers(params, cfg, tokens, embeds, keep)
    return logits, PrefillCache(*stacked)


def prefill_paged(params, cfg: ModelConfig, tokens: torch.Tensor,
                  k: torch.Tensor | None, v: torch.Tensor | None,
                  pages: torch.Tensor, ssm: torch.Tensor | None,
                  conv: torch.Tensor | None, slots: torch.Tensor
                  ) -> torch.Tensor:
    """One-shot prefill of same-length prompts written into the serving
    engine's state in place: ``prefill``'s forward, each layer's K/V
    written into the sequences' pages of the pools k/v [L, P, Hkv, page,
    D] (``attention.write_pages``; pages [B, ceil(S / page)] int32, the
    last page's tail zeroed) and its final SSM state and conv window into
    rows ``slots`` [B] of ssm [L, rows, H, P, N] / conv [L, rows, W - 1,
    conv_ch].  Every index is a device tensor and nothing is read back to
    the host, so one captured CUDA graph per (B, S) serves every group of
    that shape.  Returns the last token's logits [B, Vpad] fp32."""
    def keep(layer, caches):
        k_new, v_new, state, window = caches
        if k_new is not None:
            attn_lib.write_pages(k[layer], v[layer], pages, k_new, v_new)
        if state is not None:
            ssm[layer].index_copy_(0, slots, state.to(ssm.dtype))
            conv[layer].index_copy_(0, slots, window.to(conv.dtype))

    return _prefill_layers(params, cfg, tokens, None, keep)


def prefill_chunk(params, cfg: ModelConfig, tokens: torch.Tensor,
                  k: torch.Tensor, v: torch.Tensor, block_table: torch.Tensor,
                  start: int | torch.Tensor, n_valid: int | torch.Tensor,
                  trash_page: int) -> torch.Tensor:
    """One *chunk* of a paged prefill: positions ``start + [0, C)``.

    tokens [B, C] int32, every sequence at the same ``start``; only the
    first ``n_valid`` positions are real (the bucketed tail writes to
    ``trash_page``).  Each layer writes the chunk's K/V into the pools
    k/v [L, P, Hkv, page, D] in place and attends to the earlier chunks
    through ``block_table`` [B, n_pages] (pages covering ``start + C``).
    ``start`` and ``n_valid`` are ints or int32 device scalars, as the
    JAX package's jitted chunk takes them: with scalars nothing here reads
    a device value back to the host, so a captured CUDA graph of one
    (chunk bucket, page bucket) serves every offset and length.
    Returns the logits at position ``start + n_valid - 1`` [B, Vpad] fp32.
    Models with SSM layers raise, as in the JAX package: the SSD scan has
    no per-position state to resume a bucketed chunk from.
    """
    if cfg.has_ssm:
        raise NotImplementedError(
            "chunked prefill supports attention-only models")
    B, C = tokens.shape
    x = embed_inputs(params, cfg, tokens, None,
                     _positions(B, C, tokens.device, start))
    for layer in range(cfg.n_layers):
        bp = layer_params(params["blocks"], layer)
        h = rms_norm(x, bp["ln1"], cfg.norm_eps)
        mix = attn_lib.prefill_chunk_attention(
            h, bp["attn"], cfg, k[layer], v[layer], block_table, start,
            n_valid, trash_page, cfg.local_is_local(layer))
        x = _mlp_residual(_mix_residual(x, mix, bp, cfg), bp, cfg)
    return lm_logits(params, cfg, _last_row(x, n_valid))[:, 0]


# --------------------------------------------------------------------------
# Decode.
# --------------------------------------------------------------------------


def _decode_core(params, cfg: ModelConfig, tokens, embeds, pos, attend,
                 ssm: torch.Tensor | None, conv: torch.Tensor | None):
    """The decode-step body shared by the dense and paged caches: embed at
    ``pos`` [B], the layers, logits.  ``attend(h, p, layer)`` is one
    layer's attention; the SSM rows ssm/conv [L, B, ...] are updated in
    place.  Returns logits [B, Vpad] fp32."""
    x = embed_inputs(params, cfg, None if tokens is None else tokens[:, None],
                     embeds, pos[:, None])
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


def decode_step(params, cfg: ModelConfig, tokens: torch.Tensor | None,
                cache: DecodeCache, embeds: torch.Tensor | None = None):
    """One token for every sequence against a dense cache.

    tokens [B] int32 (or embeds [B, 1, d] for stub-frontend archs).  Each
    layer writes its new K/V at ``cache.pos`` and its SSM rows in place,
    then attends to [start, pos + 1).
    Returns (logits [B, Vpad] fp32, cache with pos + 1).
    """
    def attend(h, p, layer):
        return attn_lib.decode_attention(
            h, p, cfg, cache.k[layer], cache.v[layer], cache.pos,
            cfg.local_is_local(layer))

    logits = _decode_core(params, cfg, tokens, embeds, cache.pos, attend,
                          cache.ssm, cache.conv)
    return logits, dataclasses.replace(cache, pos=cache.pos + 1)


def decode_step_paged(params, cfg: ModelConfig, tokens: torch.Tensor | None,
                      state: PagedDecodeState,
                      embeds: torch.Tensor | None = None):
    """One token for every sequence, attending the paged pool directly.

    tokens [B] int32 (or embeds [B, 1, d] for stub-frontend archs); the
    step writes and embeds at ``state.lens``.  Each layer's new K/V token
    is written into its page in place and attention reads pages through
    the block table; each SSM layer's state and conv window rows are
    updated in place.
    Returns (logits [B, Vpad] fp32, state with lens + 1).
    """
    def attend(h, p, layer):
        return attn_lib.paged_decode_attention(
            h, p, cfg, state.k[layer], state.v[layer], state.block_table,
            state.lens, cfg.local_is_local(layer))

    logits = _decode_core(params, cfg, tokens, embeds, state.lens, attend,
                          state.ssm, state.conv)
    return logits, dataclasses.replace(state, lens=state.lens + 1)


def decode_loop_paged(params, cfg: ModelConfig, tokens: torch.Tensor,
                      state: PagedDecodeState, horizon: int, *,
                      temperature: float = 0.0, seed: int = 0,
                      step0: int | torch.Tensor = 0, step=None):
    """``horizon`` decode steps with the tokens kept on the device.

    The scatter-first loop: each step writes its K/V token into the pool
    and its SSM rows in place, attends, samples and feeds the token straight
    back.  Nothing here reads a value back to the host; the caller makes
    one transfer of the returned [B, horizon] block per horizon.  Page
    capacity for ``horizon`` more tokens per sequence must already be in
    the block table.  With ``temperature > 0`` step ``step0 + i`` samples
    with ``sampling.sample_step(seed, step0 + i)``, so sampled streams do
    not depend on the horizon; ``step0`` is an int or an int64 device
    scalar (the decode graph's buffer: one capture serves every step).
    ``step`` replaces ``decode_step_paged`` (``models.sharded`` passes its
    own, with ``params`` its ``ShardedModel``).
    Returns (tokens [B, horizon] int32, state with lens + horizon).
    """
    step = step or decode_step_paged
    out = []
    for i in range(horizon):
        logits, state = step(params, cfg, tokens, state)
        tokens = sample_step(logits, cfg, seed, step0 + i, temperature)
        out.append(tokens)
    return torch.stack(out, dim=1), state
