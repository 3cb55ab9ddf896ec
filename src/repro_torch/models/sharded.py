"""One serving replica's model, sharded explicitly over its (pp, tp) mesh.

This is the port's explicit form of what GSPMD does for the JAX package's
``repro/models/`` under ``sharding_rules`` with the serve plan: JAX keeps
one program over ``NamedSharding``-placed arrays and lets the partitioner
insert the collectives; PyTorch has nothing that runs several shards
inside one process (DTensor needs a process per rank, and NCCL refuses two
ranks on one card), so a ``ShardedModel`` holds one parameter dict per
(pipe, model) coordinate (``launch.sharding.shard_params``), each on that
coordinate's device, and reduces partial results at six fixed points:

  1. **Embedding.**  ``embed`` is vocab-sharded: each shard looks up the ids
     in its own row range and writes zeros elsewhere; the shards' results
     are summed.
  2. **Row-parallel outputs.**  Attention's ``wo``, the MLP's ``w_down``
     and the SSD mixer's ``out_proj`` are split by rows; their partial
     outputs are summed over the model axis, and ``b_down`` is added once,
     after the sum.
  3. **Logits.**  Vocab-parallel, concatenated (``embed.T`` per shard when
     embeddings are tied); the final softcap after the concatenation.
  4. **Pipeline stages.**  Stage s runs its layer range
     (``launch.sharding.layer_layout``), then hands the hidden state to the
     next stage's first device.
  5. **Gated norm.**  The SSD mixer's gated RMS norm takes the mean of
     y * silu(z) squared over all of d_inner, whose heads the shards split
     (``launch.sharding.ssm_layout``): each shard's fp32 sum of squares is
     summed in shard order, and every shard normalises its own columns with
     the shared mean before its ``out_proj`` rows (point 2).
  6. **MoE.**  The router (fp32 softmax, top-k, and above ``DENSE_TOKENS``
     the capacity ``dispatch``) runs once, on the stage's first device;
     every shard combines the same gates and keeps and drops the same
     (token, slot) pairs, computes the part of its experts ("ep": experts
     over `model`) or of its slice of every expert's ff axis ("tp"), and
     the parts are summed in shard order.

Norms, residuals, sandwich norms, hymba's normalised average of its two
mixers (after both reductions) and sampling stay replicated, computed once
on the stage's first device.  Sums run in shard order on the model group's
first device, so repeats are bit-equal; with tp = pp = 1 every path does
exactly the unsharded model's operations.  A shard's attention, MLP and
SSD mixer are the unsharded per-layer functions (``attention.full_attention``,
``prefill_chunk_attention``, ``paged_decode_attention``, ``layers.mlp``,
``ssm.ssm_scan``, ``ssm.ssm_decode_scan``, ``moe.dense_experts``,
``moe.capacity_experts``) called with the shard's own weights and a config
of its local head counts (``launch.sharding.local_config``), so on the
card a shard launches the same kernels (B1, B2, B4) at its local shapes.

A sharded paged pool is a ``ShardGrid`` of per-shard tensors
``[L_stage, P + 1, Hkv_shard, page, D]`` (``serving.kvcache.BlockPool``
with ``mesh=``); a ``PagedDecodeState`` or ``PrefillCache`` of a sharded
model holds ``ShardGrid``s in its ``k``/``v`` and, with SSM layers, in its
``ssm`` ([L_stage, B, H_shard, P, N]) and ``conv`` ([L_stage, B, W - 1,
H_shard * P + 2 G N]: the shard's own xs channels and the whole B/C tail).
Chunked prefill stays attention-only, as unsharded.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.launch.sharding import (ShardingPlan, attn_layout,
                                         layer_layout, local_config,
                                         shard_params, split_ranges,
                                         ssm_layout)
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import mlp, rms_norm, softcap
from repro_torch.models import model as model_lib
from repro_torch.models.model import (PagedDecodeState, PrefillCache,
                                      _combine, _mix_residual, _mlp_residual,
                                      _positions, embed_inputs, layer_params)


def _idx_on(idx, device: torch.device):
    """An index with its tensors on ``device``."""
    if isinstance(idx, tuple):
        return tuple(_idx_on(i, device) for i in idx)
    if isinstance(idx, torch.Tensor):
        return _on(idx, device)
    return idx


class ShardGrid:
    """One logical array as a (pp, tp) grid of per-shard tensors.

    Indexing maps over the shards: ``grid[:, i]`` is the grid of each
    shard's ``t[:, i]``, and ``grid[:, i] = other`` writes each shard's
    part of the grid ``other`` in place; index tensors move to each
    shard's device.  A shard that holds none of the array (no heads or no
    layers of it) may be None, and maps to None."""

    def __init__(self, parts: list[list[torch.Tensor | None]]):
        self.parts = parts

    def map(self, fn) -> "ShardGrid":
        return ShardGrid([[None if t is None else fn(t) for t in row]
                          for row in self.parts])

    def __getitem__(self, idx) -> "ShardGrid":
        return self.map(lambda t: t[_idx_on(idx, t.device)])

    def __setitem__(self, idx, value: "ShardGrid") -> None:
        for pi, mi, t in self:
            if t is not None:
                t[_idx_on(idx, t.device)] = value.parts[pi][mi]

    def __iter__(self):
        """(pipe, model, tensor) for every shard."""
        for pi, row in enumerate(self.parts):
            for mi, t in enumerate(row):
                yield pi, mi, t


def _on(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    return t if t.device == device else t.to(device)


def _reduce(parts: list[torch.Tensor], device: torch.device) -> torch.Tensor:
    """Sum partial results in shard order on ``device``."""
    acc = None
    for p in parts:
        p = _on(p, device)
        acc = p if acc is None else acc + p
    return acc


@dataclasses.dataclass
class ShardedModel:
    """A replica's shards and their layout (see the module docstring)."""
    cfg: ModelConfig                  # the plan's run config
    plan: ShardingPlan
    mesh: object                      # launch.mesh.ReplicaMesh
    shards: list                      # [pp][tp] parameter dicts
    layers: list                      # per stage (l0, l1)
    heads: list                       # per model shard (q0, q1, kv0, kv1)
    ssm_heads: list                   # per model shard (h0, h1)
    vocab: list                       # per model shard (v0, v1)
    local_cfgs: list                  # per model shard, local head counts

    @classmethod
    def build(cls, params, cfg: ModelConfig, plan: ShardingPlan, mesh
              ) -> "ShardedModel":
        """Shard ``params`` (already padded to ``cfg`` in "pad" mode)."""
        heads = attn_layout(cfg, plan.rules, mesh.tp)
        ssm = ssm_layout(cfg, plan.rules, mesh.tp)
        return cls(cfg, plan, mesh, shard_params(params, cfg, plan, mesh),
                   layer_layout(cfg.n_layers, plan.rules, mesh.pp), heads,
                   ssm, split_ranges(cfg.padded_vocab(), mesh.tp),
                   [local_config(cfg, h, s) for h, s in zip(heads, ssm)])

    @property
    def pp(self) -> int:
        return self.mesh.pp

    @property
    def tp(self) -> int:
        return self.mesh.tp

    def attn_shards(self) -> list[int]:
        """Model shards that hold query heads."""
        return [mi for mi, h in enumerate(self.heads) if h[1] > h[0]]

    def ssm_shards(self) -> list[int]:
        """Model shards that hold SSM heads."""
        return [mi for mi, h in enumerate(self.ssm_heads) if h[1] > h[0]]

    def first_expert(self, mi: int) -> int:
        """The first expert of model shard ``mi``'s MoE leaves: its slice
        of the experts in "ep" mode, 0 where every shard holds every
        expert ("tp" mode: a slice of each expert's ff axis)."""
        if self.plan.rules["experts"] != "model":
            return 0
        return split_ranges(self.cfg.n_experts, self.tp)[mi][0]

    def stages(self):
        """(pipe index, its first device, its layer range) of every stage
        holding layers."""
        for pi, (l0, l1) in enumerate(self.layers):
            if l1 > l0:
                yield pi, self.mesh.device(pi, 0), range(l0, l1)


# --------------------------------------------------------------------------
# The reduction points.
# --------------------------------------------------------------------------


def _embed(sm: ShardedModel, tokens: torch.Tensor,
           positions: torch.Tensor) -> torch.Tensor:
    """Vocab-parallel lookup: each shard reads the ids in its row range,
    zeros elsewhere, summed on the first device; then the replicated
    scale and positions (``embed_inputs``)."""
    dev = sm.mesh.first
    parts = []
    for mi, (v0, v1) in enumerate(sm.vocab):
        table = sm.shards[0][mi]["embed"]
        ids = _on(tokens, table.device).long() - v0
        inside = (ids >= 0) & (ids < v1 - v0)
        rows = table[ids.clamp(0, max(v1 - v0 - 1, 0))]
        parts.append(torch.where(inside[..., None], rows,
                                 torch.zeros((), dtype=rows.dtype,
                                             device=rows.device)))
    return embed_inputs(sm.shards[0][0], sm.cfg, None,
                        _reduce(parts, dev), positions)


def _logits(sm: ShardedModel, x: torch.Tensor) -> torch.Tensor:
    """Final norm (replicated), vocab-parallel head, concatenated on the
    last stage's first device, then the softcap: [.., Vpad] fp32."""
    last = sm.pp - 1
    dev = sm.mesh.device(last, 0)
    cfg = sm.cfg
    x = rms_norm(x, sm.shards[last][0]["final_norm"], cfg.norm_eps)
    parts = []
    for mi in range(sm.tp):
        p = sm.shards[last][mi]
        head = p["embed"].T if cfg.tie_embeddings else p["lm_head"]
        parts.append(_on(_on(x, head.device) @ head, dev))
    logits = torch.cat(parts, dim=-1).float()
    return softcap(logits, cfg.final_logit_softcap)


def _mlp(sm: ShardedModel, pi: int, layer: int, h: torch.Tensor
         ) -> torch.Tensor:
    """Column-parallel up/gate, row-parallel down, summed; ``b_down``
    once after the sum."""
    parts, b_down = [], None
    for mi in range(sm.tp):
        p = layer_params(sm.shards[pi][mi]["blocks"]["mlp"], layer)
        bias = p.pop("b_down", None)
        if mi == 0:
            b_down = bias
        parts.append(mlp(_on(h, p["w_up"].device), p, sm.cfg.mlp_variant))
    out = _reduce(parts, h.device)
    if b_down is not None:
        out = out + b_down
    return out


def _moe(sm: ShardedModel, pi: int, layer: int, h: torch.Tensor
         ) -> torch.Tensor:
    """Routed once on the stage's first device (``moe.dense_gates`` up to
    ``moe.DENSE_TOKENS`` tokens, ``moe.dispatch`` above), then each
    shard's part of the experts with the same gates and drops, summed in
    shard order."""
    cfg = sm.cfg
    B, S, d = h.shape
    router = sm.shards[pi][0]["blocks"]["moe"]["router"][layer]
    dense = B * S <= moe_lib.DENSE_TOKENS
    xt = h.reshape(B * S, d)
    routing = (moe_lib.dense_gates(xt, router, cfg.top_k) if dense
               else moe_lib.dispatch(h, {"router": router}, cfg))
    parts = []
    for mi in range(sm.tp):
        p = layer_params(sm.shards[pi][mi]["blocks"]["moe"], layer)
        if not p["w_gate"].numel():
            continue                  # no experts, or no ff, on this shard
        dev, e0 = p["w_gate"].device, sm.first_expert(mi)
        if dense:
            gates = _on(routing, dev)[:, e0:e0 + p["w_gate"].shape[0]]
            parts.append(moe_lib.dense_experts(_on(xt, dev), p, gates)
                         .reshape(B, S, d))
        else:
            parts.append(moe_lib.capacity_experts(
                _on(h, dev), p, _idx_on(routing, dev), e0))
    return _reduce(parts, h.device)


def _ssm(sm: ShardedModel, pi: int, layer: int, h: torch.Tensor, scan
         ) -> torch.Tensor:
    """The SSD mixer: ``scan(mi, h, p, cfg_local)`` is one shard's
    y * silu(z) over its heads [..., H_shard * P] fp32; the gated norm's
    mean square is reduced over the shards (one holder takes its own mean,
    the unsharded operation), each shard normalises its columns and
    multiplies by its ``out_proj`` rows, and the parts are summed."""
    cfg = sm.cfg
    ps, ys = [], []
    for mi in sm.ssm_shards():
        p = layer_params(sm.shards[pi][mi]["blocks"]["ssm"], layer)
        ps.append(p)
        ys.append(scan(mi, _on(h, p["w_x"].device), p, sm.local_cfgs[mi]))
    if len(ys) == 1:
        var = [ssm_lib.mean_square(ys[0])]
    else:
        total = _reduce([torch.sum(y * y, dim=-1, keepdim=True)
                         for y in ys], h.device) / cfg.d_inner
        var = [_on(total, y.device) for y in ys]
    return _reduce([ssm_lib.gated_norm_from(y, v, p["norm_w"], cfg.norm_eps)
                    .to(h.dtype) @ p["out_proj"]
                    for y, v, p in zip(ys, var, ps)], h.device)


def _layer(sm: ShardedModel, pi: int, layer: int, x: torch.Tensor,
           attend, scan=None) -> torch.Tensor:
    """One layer of stage ``pi`` (local layer index ``layer``): replicated
    norms, residuals and hymba's average on the stage's first device
    around the reduced attention (``attend(mi, h, attn_params, cfg_local)``
    is one shard's partial output), the reduced SSD mixer (``scan``, see
    ``_ssm``) and the reduced MLP or MoE."""
    cfg = sm.cfg
    bp = layer_params({k: v for k, v in sm.shards[pi][0]["blocks"].items()
                       if k not in ("attn", "ssm", "mlp", "moe")}, layer)
    h = rms_norm(x, bp["ln1"], cfg.norm_eps)
    attn_out = ssm_out = None
    if cfg.has_attn:
        parts = []
        for mi in sm.attn_shards():
            p = layer_params(sm.shards[pi][mi]["blocks"]["attn"], layer)
            parts.append(attend(mi, _on(h, p["wq"].device), p,
                                sm.local_cfgs[mi]))
        attn_out = _reduce(parts, x.device)
    if cfg.has_ssm:
        ssm_out = _ssm(sm, pi, layer, h, scan)
    x = _mix_residual(x, _combine(attn_out, ssm_out, bp, cfg), bp, cfg)
    ffn = _moe if cfg.is_moe else _mlp
    return _mlp_residual(x, bp, cfg, ffn=lambda h: ffn(sm, pi, layer, h))


# --------------------------------------------------------------------------
# Entry points: the unsharded model's signatures with a ShardedModel.
# --------------------------------------------------------------------------


def forward(sm: ShardedModel, cfg: ModelConfig, tokens: torch.Tensor
            ) -> torch.Tensor:
    """tokens [B, S] -> logits [B, S, Vpad] fp32 (``models.forward``)."""
    return _prefill(sm, tokens, all_positions=True)[0]


def prefill(sm: ShardedModel, cfg: ModelConfig, tokens: torch.Tensor):
    """One-shot prefill (``models.prefill``): tokens [B, S] ->
    (last-token logits [B, Vpad] fp32, PrefillCache whose k/v are grids of
    each shard's [L_stage, B, S, Hkv_shard, D] and whose ssm/conv are
    grids of each shard's final SSM state [L_stage, B, H_shard, P, N] and
    conv window [L_stage, B, W - 1, H_shard * P + 2 G N]; None where the
    model has no such state)."""
    return _prefill(sm, tokens, all_positions=False)


def _grid(sm: ShardedModel) -> list:
    return [[None] * sm.tp for _ in range(sm.pp)]


def _prefill(sm: ShardedModel, tokens: torch.Tensor, all_positions: bool):
    B, S = tokens.shape
    x = None
    # per stage, per layer: the k, v, ssm and conv of each shard
    per_layer = [[] for _ in range(sm.pp)]
    for pi, dev, layers in sm.stages():
        positions = _positions(B, S, dev)
        if x is None:
            x = _embed(sm, _on(tokens, dev), positions)
        x = _on(x, dev)
        for layer in layers:
            kept = [_grid(sm) for _ in range(4)]
            is_local = sm.cfg.local_is_local(layer)

            def attend(mi, h, p, lcfg, pi=pi, kept=kept, is_local=is_local):
                out, k, v = attn_lib.full_attention(
                    h, p, lcfg, _on(positions, h.device), is_local)
                kept[0][pi][mi], kept[1][pi][mi] = k, v
                return out

            def scan(mi, h, p, lcfg, pi=pi, kept=kept):
                yg, state, conv = ssm_lib.ssm_scan(h, p, lcfg)
                kept[2][pi][mi], kept[3][pi][mi] = state, conv
                return yg

            x = _layer(sm, pi, layer - sm.layers[pi][0], x, attend, scan)
            per_layer[pi].append(kept)
    x = _on(x, sm.mesh.device(sm.pp - 1, 0))
    if all_positions:
        return _logits(sm, x), None
    k, v, ssm, conv = _stack_prefill(per_layer, sm)
    return (_logits(sm, x[:, -1:, :])[:, 0],
            PrefillCache(*(g if has else None for g, has in zip(
                (k, v, ssm, conv), (sm.cfg.has_attn,) * 2
                + (sm.cfg.has_ssm,) * 2))))


def _stack_prefill(per_layer, sm: ShardedModel):
    """Grids of each shard's layer-stacked prefill k, v, ssm and conv
    (None for a shard without heads of that kind or without layers)."""
    grids = []
    for j in range(4):
        parts = _grid(sm)
        for pi in range(sm.pp):
            for mi in range(sm.tp):
                ts = [kept[j][pi][mi] for kept in per_layer[pi]]
                if ts and ts[0] is not None:
                    parts[pi][mi] = torch.stack(ts)
        grids.append(ShardGrid(parts))
    return grids


def prefill_chunk(sm: ShardedModel, cfg: ModelConfig, tokens: torch.Tensor,
                  k: ShardGrid, v: ShardGrid, block_table: torch.Tensor,
                  start: int, n_valid: int, trash_page: int) -> torch.Tensor:
    """One chunk of a paged prefill (``models.prefill_chunk``) into the
    sharded pools ``k``/``v``; each shard writes and attends its own
    heads and layers.  Returns the logits at position start + n_valid - 1
    [B, Vpad] fp32.  Models with SSM layers raise, as unsharded."""
    if cfg.has_ssm:
        raise NotImplementedError(
            "chunked prefill supports attention-only models")
    B, C = tokens.shape
    x = None
    tables: dict = {}
    for pi, dev, layers in sm.stages():
        if x is None:
            x = _embed(sm, _on(tokens, dev), _positions(B, C, dev, start))
        x = _on(x, dev)
        for layer in layers:
            local = layer - sm.layers[pi][0]
            is_local = sm.cfg.local_is_local(layer)

            def attend(mi, h, p, lcfg, pi=pi, local=local,
                       is_local=is_local):
                table = tables.setdefault(
                    h.device, _on(block_table, h.device))
                return attn_lib.prefill_chunk_attention(
                    h, p, lcfg, k.parts[pi][mi][local],
                    v.parts[pi][mi][local], table, start, n_valid,
                    trash_page, is_local)

            x = _layer(sm, pi, local, x, attend)
    x = _on(x, sm.mesh.device(sm.pp - 1, 0))
    return _logits(sm, x[:, n_valid - 1:n_valid])[:, 0]


def decode_step_paged(sm: ShardedModel, cfg: ModelConfig,
                      tokens: torch.Tensor, state: PagedDecodeState):
    """One token for every sequence (``models.decode_step_paged``) against
    the sharded pools ``state.k``/``state.v`` and the sharded SSM rows
    ``state.ssm``/``state.conv`` (grids of each shard's [L_stage, B, ...],
    updated in place).  Returns (logits [B, Vpad] fp32, state with
    lens + 1)."""
    x = None
    tables: dict = {}
    for pi, dev, layers in sm.stages():
        if x is None:
            pos = _on(state.lens, dev)
            x = _embed(sm, _on(tokens, dev)[:, None], pos[:, None])
        x = _on(x, dev)
        for layer in layers:
            local = layer - sm.layers[pi][0]
            is_local = sm.cfg.local_is_local(layer)

            def attend(mi, h, p, lcfg, pi=pi, local=local,
                       is_local=is_local):
                table, lens = tables.setdefault(h.device, (
                    _on(state.block_table, h.device),
                    _on(state.lens, h.device)))
                return attn_lib.paged_decode_attention(
                    h, p, lcfg, state.k.parts[pi][mi][local],
                    state.v.parts[pi][mi][local], table, lens, is_local)

            def scan(mi, h, p, lcfg, pi=pi, local=local):
                rows = state.ssm.parts[pi][mi], state.conv.parts[pi][mi]
                yg, rows[0][local], rows[1][local] = \
                    ssm_lib.ssm_decode_scan(h, p, lcfg, rows[0][local],
                                            rows[1][local])
                return yg[:, None]

            x = _layer(sm, pi, local, x, attend, scan)
    x = _on(x, sm.mesh.device(sm.pp - 1, 0))
    logits = _on(_logits(sm, x)[:, 0], state.lens.device)
    return logits, dataclasses.replace(state, lens=state.lens + 1)


def decode_loop_paged(sm: ShardedModel, cfg: ModelConfig,
                      tokens: torch.Tensor, state: PagedDecodeState,
                      horizon: int, **kw):
    """``horizon`` decode steps with the tokens kept on the device
    (``models.decode_loop_paged``, each step this module's
    ``decode_step_paged``)."""
    return model_lib.decode_loop_paged(sm, cfg, tokens, state, horizon,
                                       step=decode_step_paged, **kw)
