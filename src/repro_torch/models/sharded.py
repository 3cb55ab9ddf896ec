"""One serving replica's model, sharded explicitly over its (pp, tp) mesh.

This is the port's explicit form of what GSPMD does for the JAX package's
``repro/models/`` under ``sharding_rules`` with the serve plan: JAX keeps
one program over ``NamedSharding``-placed arrays and lets the partitioner
insert the collectives; PyTorch has nothing that runs several shards
inside one process (DTensor needs a process per rank, and NCCL refuses two
ranks on one card), so a ``ShardedModel`` holds one parameter dict per
(pipe, model) coordinate (``launch.sharding.shard_params``), each on that
coordinate's device, and reduces partial results at four fixed points:

  1. **Embedding.**  ``embed`` is vocab-sharded: each shard looks up the ids
     in its own row range and writes zeros elsewhere; the shards' results
     are summed.
  2. **Row-parallel outputs.**  Attention's ``wo`` and the MLP's ``w_down``
     are split by rows; their partial outputs are summed over the model
     axis, and ``b_down`` is added once, after the sum.
  3. **Logits.**  Vocab-parallel, concatenated (``embed.T`` per shard when
     embeddings are tied); the final softcap after the concatenation.
  4. **Pipeline stages.**  Stage s runs its layer range
     (``launch.sharding.layer_layout``), then hands the hidden state to the
     next stage's first device.

Norms, residuals, sandwich norms and sampling stay replicated, computed
once on the stage's first device.  Sums run in shard order on the model
group's first device, so repeats are bit-equal; with tp = pp = 1 every
path does exactly the unsharded model's operations.  A shard's attention
and MLP are the unsharded per-layer functions (``attention.full_attention``,
``prefill_chunk_attention``, ``paged_decode_attention``, ``layers.mlp``)
called with the shard's own weights and a config of its local head counts
(``launch.sharding.local_config``), so on the card a shard launches the
same kernels (B1, B2) at its local shapes.  Only attention-only dense
models run (MoE and SSM layers: ROADMAP Queue A item 9b).

A sharded paged pool is a ``ShardGrid`` of per-shard tensors
``[L_stage, P + 1, Hkv_shard, page, D]`` (``serving.kvcache.BlockPool``
with ``mesh=``); a ``PagedDecodeState`` or ``PrefillCache`` of a sharded
model holds ``ShardGrid``s in its ``k``/``v``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.launch.sharding import (ShardingPlan, attn_layout,
                                         check_executable, layer_layout,
                                         local_config, shard_params,
                                         split_ranges)
from repro_torch.models import attention as attn_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import mlp, rms_norm, softcap
from repro_torch.models import model as model_lib
from repro_torch.models.model import (PagedDecodeState, PrefillCache,
                                      _mix_residual, _mlp_residual,
                                      _positions, embed_inputs, layer_params)


class ShardGrid:
    """One logical array as a (pp, tp) grid of per-shard tensors.

    Indexing maps over the shards: ``grid[:, i]`` is the grid of each
    shard's ``t[:, i]``.  A shard that holds none of the array (no heads
    or no layers of it) may be None, and maps to None."""

    def __init__(self, parts: list[list[torch.Tensor | None]]):
        self.parts = parts

    def map(self, fn) -> "ShardGrid":
        return ShardGrid([[None if t is None else fn(t) for t in row]
                          for row in self.parts])

    def __getitem__(self, idx) -> "ShardGrid":
        return self.map(lambda t: t[idx])

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
    vocab: list                       # per model shard (v0, v1)
    local_cfgs: list                  # per model shard, local head counts

    @classmethod
    def build(cls, params, cfg: ModelConfig, plan: ShardingPlan, mesh
              ) -> "ShardedModel":
        """Shard ``params`` (already padded to ``cfg`` in "pad" mode)."""
        check_executable(cfg)
        heads = attn_layout(cfg, plan.rules, mesh.tp)
        return cls(cfg, plan, mesh, shard_params(params, cfg, plan, mesh),
                   layer_layout(cfg.n_layers, plan.rules, mesh.pp), heads,
                   split_ranges(cfg.padded_vocab(), mesh.tp),
                   [local_config(cfg, h) for h in heads])

    @property
    def pp(self) -> int:
        return self.mesh.pp

    @property
    def tp(self) -> int:
        return self.mesh.tp

    def attn_shards(self) -> list[int]:
        """Model shards that hold query heads."""
        return [mi for mi, h in enumerate(self.heads) if h[1] > h[0]]

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


def _layer(sm: ShardedModel, pi: int, layer: int, x: torch.Tensor,
           attend) -> torch.Tensor:
    """One layer of stage ``pi`` (local layer index ``layer``): replicated
    norms and residuals on the stage's first device around the reduced
    attention (``attend(mi, h, attn_params, cfg_local)`` is one shard's
    partial output) and the reduced MLP."""
    bp = layer_params({k: v for k, v in sm.shards[pi][0]["blocks"].items()
                       if k not in ("attn", "mlp")}, layer)
    h = rms_norm(x, bp["ln1"], sm.cfg.norm_eps)
    parts = []
    for mi in sm.attn_shards():
        p = layer_params(sm.shards[pi][mi]["blocks"]["attn"], layer)
        parts.append(attend(mi, _on(h, p["wq"].device), p,
                            sm.local_cfgs[mi]))
    x = _mix_residual(x, _reduce(parts, x.device), bp, sm.cfg)
    return _mlp_residual(x, bp, sm.cfg,
                         ffn=lambda h: _mlp(sm, pi, layer, h))


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
    each shard's [L_stage, B, S, Hkv_shard, D])."""
    return _prefill(sm, tokens, all_positions=False)


def _prefill(sm: ShardedModel, tokens: torch.Tensor, all_positions: bool):
    B, S = tokens.shape
    x = None
    per_layer = [[] for _ in range(sm.pp)]
    for pi, dev, layers in sm.stages():
        positions = _positions(B, S, dev)
        if x is None:
            x = _embed(sm, _on(tokens, dev), positions)
        x = _on(x, dev)
        for layer in layers:
            kv = ([[None] * sm.tp for _ in range(sm.pp)],
                  [[None] * sm.tp for _ in range(sm.pp)])
            is_local = sm.cfg.local_is_local(layer)

            def attend(mi, h, p, lcfg, pi=pi, kv=kv, is_local=is_local):
                out, k, v = attn_lib.full_attention(
                    h, p, lcfg, _on(positions, h.device), is_local)
                kv[0][pi][mi], kv[1][pi][mi] = k, v
                return out

            x = _layer(sm, pi, layer - sm.layers[pi][0], x, attend)
            per_layer[pi].append(kv)
    x = _on(x, sm.mesh.device(sm.pp - 1, 0))
    if all_positions:
        return _logits(sm, x), None
    k, v = _stack_prefill(per_layer, sm)
    return _logits(sm, x[:, -1:, :])[:, 0], PrefillCache(k, v, None, None)


def _stack_prefill(per_layer, sm: ShardedModel):
    """Grids of each shard's layer-stacked prefill k and v (shards without
    heads get an empty head axis, shards without layers an empty layer
    axis)."""
    grids = []
    for j in range(2):
        parts = []
        for pi in range(sm.pp):
            row = []
            for mi in range(sm.tp):
                ts = [kv[j][pi][mi] for kv in per_layer[pi]]
                row.append(torch.stack(ts) if ts and ts[0] is not None
                           else None)
            parts.append(row)
        grids.append(ShardGrid(parts))
    return grids


def prefill_chunk(sm: ShardedModel, cfg: ModelConfig, tokens: torch.Tensor,
                  k: ShardGrid, v: ShardGrid, block_table: torch.Tensor,
                  start: int, n_valid: int, trash_page: int) -> torch.Tensor:
    """One chunk of a paged prefill (``models.prefill_chunk``) into the
    sharded pools ``k``/``v``; each shard writes and attends its own
    heads and layers.  Returns the logits at position start + n_valid - 1
    [B, Vpad] fp32."""
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
    the sharded pools ``state.k``/``state.v``.  Returns (logits [B, Vpad]
    fp32, state with lens + 1)."""
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

            x = _layer(sm, pi, local, x, attend)
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
