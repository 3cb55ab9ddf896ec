"""Models sharded explicitly: one serving replica over its (pp, tp) mesh,
and the JAX package's train, prefill and decode plans over a (data, model)
or (pod, data, model) mesh.

This is the port's explicit form of what GSPMD does for the JAX package's
``repro/models/`` under ``sharding_rules``: JAX keeps one program over
``NamedSharding``-placed arrays and lets the partitioner insert the
collectives; PyTorch has nothing that runs several shards inside one
process (DTensor needs a process per rank, and NCCL refuses two ranks on
one card), so a ``ShardedModel`` holds one parameter dict per (pipe,
model) coordinate (``launch.sharding.shard_params``), each on that
coordinate's device, and reduces partial results at fixed points:

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

A plan with a data axis (``PlanModel``: one parameter dict per (row,
model) coordinate, row the flat batch index) adds:

  7. **Data groups.**  The batch is split over the data index
     (``launch.sharding.shard_batch``); each group runs the model-axis
     code above on its own rows, on its row of the mesh (``PlanModel.
     views``), and the groups run layer by layer together.  A batch of
     one is computed by one group.
  8. **FSDP gather.**  A leaf whose rows the plan puts over ``data``
     (``fsdp``) is gathered from the group's data peers, in shard order,
     one layer at a time as the layer reads it (``FsdpLeaf``).
  9. **Sequence-parallel residual** (``act_seq``).  Between layers the
     residual is split along the sequence over the model shards and the
     norms run on each slice; the normed slices are gathered before the
     mixer and the MLP, and the reduced outputs of point 2 are cut back
     into the slices (a reduce-scatter: the sum, then a slice).
  10. **Whole-batch MoE.**  The capacity path's groups and capacity are
     the whole batch's (``_dispatch_groups``: each group routes its own
     tokens, the slots are counted over the joined expert ids, a capacity
     group may span data groups), and the load-balance loss is a product
     of whole-batch means (``_balance``: each group's expert counts and
     probability sums, summed in shard order).
  11. **Partial softmax** (the decode plan).  The dense cache is split
     along its sequence (``kv_seq``: over ``model``, or at batch 1 over
     (data, model)); every shard projects every KV head and the shard
     owning the position writes it; the query heads are gathered; each
     sequence shard runs B3 with its log-sum-exp over its own range, and
     the partials are combined in shard order on the group's first
     device (``_combine_partials``) before each shard's ``wo`` rows.

Norms, residuals, sandwich norms, hymba's normalised average of its two
mixers (after both reductions) and sampling stay replicated, computed once
on the stage's first device.  Sums run in shard order on the model group's
first device, so repeats are bit-equal; with tp = pp = 1 every path does
exactly the unsharded model's operations, and so does a plan on the mesh
of ones.  The full-sequence pass (``run_full``: a serving replica's
``forward`` and ``prefill`` as one group, the plans' over their data
groups) runs under autograd (the trainer's sharded step; B2 and B4 sit in
``autograd.Function``s on the card, B1 and B3 raise through
``ops.grad_guard``).  A shard's attention, MLP and
SSD mixer are the unsharded per-layer functions (``attention.full_attention``,
``prefill_chunk_attention``, ``paged_decode_attention``, ``layers.mlp``,
``ssm.ssm_scan``, ``ssm.ssm_decode_scan``, ``moe.dense_experts``,
``moe.capacity_experts``) called with the shard's own weights and a config
of its local head counts (``launch.sharding.local_config``), so on the
card a shard launches the same kernels (B1, B2, B4, and B3's lse form in
the decode plan) at its local shapes.

A sharded paged pool is a ``ShardGrid`` of per-shard tensors
``[L_stage, P + 1, Hkv_shard, page, D]`` (``serving.kvcache.BlockPool``
with ``mesh=``); a ``PagedDecodeState`` or ``PrefillCache`` of a sharded
model holds ``ShardGrid``s in its ``k``/``v`` and, with SSM layers, in its
``ssm`` ([L_stage, B, H_shard, P, N]) and ``conv`` ([L_stage, B, W - 1,
H_shard * P + 2 G N]: the shard's own xs channels and the whole B/C tail).
Chunked prefill stays attention-only, as unsharded.  A plan's dense cache
is a ``DecodeCache`` of ``ShardGrid``s over [rows][tp] in
``cache_pspecs``'s layout (``launch.sharding.shard_cache``; conv windows
whole on every model shard, SSM rows by ``ssm_heads``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch.kernels import ops
from repro_torch.launch.mesh import ReplicaMesh
from repro_torch.launch.sharding import (ShardingPlan, attn_layout,
                                         axis_index, cut_cache_rows,
                                         layer_layout,
                                         local_config, n_groups,
                                         param_pspecs, shard_params,
                                         split_ranges, ssm_layout)
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import mlp, rms_norm, softcap
from repro_torch.models import model as model_lib
from repro_torch.models.model import (PagedDecodeState, PrefillCache,
                                      _combine, _mix_residual, _positions,
                                      embed_inputs, layer_params)


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


class FsdpLeaf:
    """One coordinate's view of a leaf whose rows are sharded over the
    data axis (fsdp): its data peers' parts, in data order, gathered on
    the coordinate's device when they are read: ``leaf[layer]`` gathers
    one layer (never the whole model), ``whole()`` a leaf without a layer
    axis (``lm_head``).  ``dtype`` casts after the gather (the trainer's
    compute copy)."""

    def __init__(self, parts: list, axis: int, device: torch.device,
                 dtype=None):
        self.parts, self.axis, self.device, self.dtype = (parts, axis,
                                                          device, dtype)

    def _cast(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.dtype is None else t.to(self.dtype)

    def __getitem__(self, layer: int) -> torch.Tensor:
        return self._cast(torch.cat([_on(p[layer], self.device)
                                     for p in self.parts], dim=self.axis - 1))

    def whole(self) -> torch.Tensor:
        return self._cast(torch.cat([_on(p, self.device) for p in self.parts],
                                    dim=self.axis))


def _whole(t):
    return t.whole() if isinstance(t, FsdpLeaf) else t


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
        head = p["embed"].T if cfg.tie_embeddings else _whole(p["lm_head"])
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


def _moe(sms: list, pi: int, layer: int, hs: list, aux: list | None = None
         ) -> list:
    """The MoE of every data group (``sms``, their MoE inputs ``hs``).
    Routed once a group on its stage's first device (``moe.dense_gates``
    up to ``moe.DENSE_TOKENS`` tokens of the whole batch, the capacity
    path's slots above), then each shard's part of the experts with the
    same gates and drops, summed in shard order.  The capacity groups are
    the whole batch's (``_dispatch_groups``), as are the load-balance
    loss's means (``_balance``, appended to ``aux`` when one is given)."""
    cfg = sms[0].cfg
    routers = [sm.shards[pi][0]["blocks"]["moe"]["router"][layer]
               for sm in sms]
    if aux is not None:
        aux.append(_balance(hs, routers, cfg))
    dense = sum(h.shape[0] * h.shape[1] for h in hs) <= moe_lib.DENSE_TOKENS
    if dense:
        routes = [moe_lib.dense_gates(h.reshape(-1, h.shape[-1]), r,
                                      cfg.top_k)
                  for h, r in zip(hs, routers)]
    elif len(sms) == 1:
        routes = [(moe_lib.dispatch(hs[0], {"router": routers[0]}, cfg), 0,
                   hs[0].shape[0])]
    else:
        routes = _dispatch_groups(hs, routers, cfg)
    return [_experts(sm, pi, layer, h, route, dense)
            for sm, h, route in zip(sms, hs, routes)]


def _experts(sm: ShardedModel, pi: int, layer: int, h: torch.Tensor,
             route, dense: bool) -> torch.Tensor:
    """One group's experts: dense gates [N, E], or (capacity routing of
    ``rows`` rows, the group's first row ``lo`` among them): h is padded
    with zero rows to whole capacity groups and the padding cut off."""
    B, S, d = h.shape
    if not dense:
        routing, lo, rows = route
        x = _pad_rows(h, lo, rows, 0)
    parts = []
    for mi in range(sm.tp):
        p = layer_params(sm.shards[pi][mi]["blocks"]["moe"], layer)
        if not p["w_gate"].numel():
            continue                  # no experts, or no ff, on this shard
        dev, e0 = p["w_gate"].device, sm.first_expert(mi)
        if dense:
            gates = _on(route, dev)[:, e0:e0 + p["w_gate"].shape[0]]
            parts.append(moe_lib.dense_experts(
                _on(h.reshape(B * S, d), dev), p, gates).reshape(B, S, d))
        else:
            y = moe_lib.capacity_experts(_on(x, dev), p,
                                         _idx_on(routing, dev), e0)
            parts.append(y if rows == B else y[lo:lo + B])
    return _reduce(parts, h.device)


def _pad_rows(t: torch.Tensor, lo: int, rows: int, fill) -> torch.Tensor:
    """``t`` [n, ...] at rows [lo, lo + n) of ``rows`` rows, ``fill``
    elsewhere (itself when it fills them)."""
    n = t.shape[0]
    if lo == 0 and rows == n:
        return t

    def pad(k):
        return torch.full((k, *t.shape[1:]), fill, dtype=t.dtype,
                          device=t.device)
    return torch.cat([pad(lo), t, pad(rows - lo - n)])


def _dispatch_groups(hs: list, routers: list, cfg: ModelConfig) -> list:
    """The capacity path's routing of a batch split over data groups.

    The groups G and capacity C are the whole batch's (``moe.
    capacity_groups`` of its B sequences, as the JAX package picks them
    from the global batch): a group that called ``_pick_groups`` on its
    own rows could pick another group size, hence other drops.  Each data
    group routes its own tokens; the expert ids of all of them are joined
    in batch order and their slots counted over each capacity group
    (``moe.capacity_slots``), which may span data groups.  Returns, per
    data group, (its routing over the capacity groups its rows touch,
    padded to whole groups; its first row in them; their row count)."""
    E, K = cfg.n_experts, cfg.top_k
    S = hs[0].shape[1]
    B = sum(h.shape[0] for h in hs)
    G, C = moe_lib.capacity_groups(S, B, cfg)
    R = B // G                            # rows per capacity group
    dev = hs[0].device
    routes = [moe_lib._route(h, r, K) for h, r in zip(hs, routers)]
    topi = torch.cat([_on(t, dev) for _, _, t in routes])
    keep, slot = moe_lib.capacity_slots(topi.reshape(G, R * S, K), E, C)
    keep, slot = keep.reshape(B, S, K), slot.reshape(B, S, K)
    out, r0 = [], 0
    for h, (_, gates, _) in zip(hs, routes):
        b = h.shape[0]
        g0, g1 = r0 // R, -(-(r0 + b) // R)
        lo, rows = r0 - g0 * R, (g1 - g0) * R

        def grouped(t, fill, b=b, lo=lo, rows=rows, n=g1 - g0):
            t = _pad_rows(_on(t, h.device), lo, rows, fill)
            return t.reshape(n, R * S, K)
        out.append(((g1 - g0, C, grouped(gates, 0),
                     grouped(keep[r0:r0 + b], False),
                     grouped(slot[r0:r0 + b], E * C)), lo, rows))
        r0 += b
    return out


def _balance(hs: list, routers: list, cfg: ModelConfig) -> torch.Tensor:
    """The load-balance loss of the whole batch: one group's is
    ``moe.load_balance_loss``; over several, each group's expert counts
    and probability sums (``moe.balance_sums``) are summed in shard order
    and divided by the batch's token count once, before the product (the
    groups' losses are never summed or averaged)."""
    if len(hs) == 1:
        return moe_lib.load_balance_loss(hs[0], {"router": routers[0]}, cfg)
    dev = hs[0].device
    sums = [moe_lib.balance_sums(h, r, cfg) for h, r in zip(hs, routers)]
    counts = _reduce([c for c, _ in sums], dev)
    probs = _reduce([p for _, p in sums], dev)
    T = sum(h.shape[0] * h.shape[1] for h in hs)
    return cfg.n_experts * torch.sum((counts / T) * (probs / T)) / cfg.top_k


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


def _norms(sm: ShardedModel, pi: int, mi: int, layer: int) -> dict:
    """Model shard ``mi``'s copy of a layer's replicated leaves (the
    norms)."""
    return layer_params({k: v for k, v in sm.shards[pi][mi]["blocks"].items()
                         if k not in ("attn", "ssm", "mlp", "moe")}, layer)


def _gather_seq(hs: list, device: torch.device) -> torch.Tensor:
    """The residual's sequence slices joined on ``device`` (one slice is
    the whole residual)."""
    if len(hs) == 1:
        return hs[0]
    return torch.cat([_on(h, device) for h in hs], dim=1)


def _scatter_seq(t: torch.Tensor | None, xs: list) -> list:
    """``t`` [B, S, ...] cut along the sequence as the slices ``xs`` are,
    each part on its slice's device (one slice: ``t`` itself)."""
    if t is None or len(xs) == 1:
        return [t] * len(xs)
    out, s0 = [], 0
    for x in xs:
        out.append(_on(t[:, s0:s0 + x.shape[1]], x.device))
        s0 += x.shape[1]
    return out


def _split_seq(x: torch.Tensor, sm: ShardedModel, pi: int = 0) -> list:
    """The residual [B, S, d] split along the sequence over the model
    shards (``split_ranges``), slice m on device (pi, m)."""
    return [_on(x[:, s0:s1], sm.mesh.device(pi, mi))
            for mi, (s0, s1) in enumerate(split_ranges(x.shape[1], sm.tp))]


def _shard_attn(sm: ShardedModel, pi: int, layer: int, h: torch.Tensor,
                attend) -> torch.Tensor:
    """Each attention shard's partial output (``attend(mi, h,
    attn_params, cfg_local)``), summed in shard order."""
    parts = []
    for mi in sm.attn_shards():
        p = layer_params(sm.shards[pi][mi]["blocks"]["attn"], layer)
        parts.append(attend(mi, _on(h, p["wq"].device), p,
                            sm.local_cfgs[mi]))
    return _reduce(parts, h.device)


def _mixer(sm: ShardedModel, pi: int, layer: int, xs: list, attn, ssm
           ) -> list:
    """A layer's mixer and its residual on the residual slices ``xs``
    (one, or with the sequence-parallel residual one a model shard, each
    normed with that shard's copy of the gains): the normed slices are
    gathered, ``attn(h)`` and ``ssm(h)`` give the reduced attention and
    SSD outputs, which are cut back into the slices (the sum followed by
    a slice: a reduce-scatter), and hymba's average and the residual run
    on each slice."""
    cfg = sm.cfg
    bps = [_norms(sm, pi, mi if len(xs) > 1 else 0, layer)
           for mi in range(len(xs))]
    h = _gather_seq([rms_norm(x, bp["ln1"], cfg.norm_eps)
                     for x, bp in zip(xs, bps)], sm.mesh.device(pi, 0))
    attn_s = _scatter_seq(attn(h) if cfg.has_attn else None, xs)
    ssm_s = _scatter_seq(ssm(h) if cfg.has_ssm else None, xs)
    return [_mix_residual(x, _combine(a, y, bp, cfg), bp, cfg)
            for x, a, y, bp in zip(xs, attn_s, ssm_s, bps)]


def _ffn(sms: list, pi: int, layer: int, xss: list,
         aux: list | None = None) -> list:
    """The MLP or MoE of every data group and its residual, on each
    group's residual slices (as ``_mixer``); MoE groups route together
    (``_moe``)."""
    cfg = sms[0].cfg
    if not (cfg.is_moe or cfg.d_ff > 0):
        return xss
    bpss, hs = [], []
    for sm, xs in zip(sms, xss):
        bps = [_norms(sm, pi, mi if len(xs) > 1 else 0, layer)
               for mi in range(len(xs))]
        bpss.append(bps)
        hs.append(_gather_seq([rms_norm(x, bp["ln2"], cfg.norm_eps)
                               for x, bp in zip(xs, bps)],
                              sm.mesh.device(pi, 0)))
    ms = (_moe(sms, pi, layer, hs, aux) if cfg.is_moe
          else [_mlp(sm, pi, layer, h) for sm, h in zip(sms, hs)])
    out = []
    for xs, m, bps in zip(xss, ms, bpss):
        out.append([x + (rms_norm(part, bp["post_ln2"], cfg.norm_eps)
                         if cfg.sandwich_norm else part)
                    for x, part, bp in zip(xs, _scatter_seq(m, xs), bps)])
    return out


def _layer(sm: ShardedModel, pi: int, layer: int, x: torch.Tensor,
           attend, scan=None) -> torch.Tensor:
    """One layer of stage ``pi`` (local layer index ``layer``) of one
    replica: replicated norms, residuals and hymba's average on the
    stage's first device around the reduced attention (``attend(mi, h,
    attn_params, cfg_local)`` is one shard's partial output), the reduced
    SSD mixer (``scan``, see ``_ssm``) and the reduced MLP or MoE."""
    xs = _mixer(sm, pi, layer, [x],
                lambda h: _shard_attn(sm, pi, layer, h, attend),
                lambda h: _ssm(sm, pi, layer, h, scan))
    return _ffn([sm], pi, layer, [xs])[0][0]


# --------------------------------------------------------------------------
# Entry points: the unsharded model's signatures with a ShardedModel.
# --------------------------------------------------------------------------


def forward(sm: ShardedModel, cfg: ModelConfig, tokens: torch.Tensor
            ) -> torch.Tensor:
    """tokens [B, S] -> logits [B, S, Vpad] fp32 (``models.forward``)."""
    return run_full([sm], [tokens])[0][0]


def prefill(sm: ShardedModel, cfg: ModelConfig, tokens: torch.Tensor):
    """One-shot prefill (``models.prefill``): tokens [B, S] ->
    (last-token logits [B, Vpad] fp32, PrefillCache whose k/v are grids of
    each shard's [L_stage, B, S, Hkv_shard, D] and whose ssm/conv are
    grids of each shard's final SSM state [L_stage, B, H_shard, P, N] and
    conv window [L_stage, B, W - 1, H_shard * P + 2 G N]; None where the
    model has no such state)."""
    logits, _, kept = run_full([sm], [tokens], keep=True, last_only=True)
    grids = _stack_state(sm, kept, 0)
    return logits[0], PrefillCache(*(g if has else None for g, has in zip(
        grids, (sm.cfg.has_attn,) * 2 + (sm.cfg.has_ssm,) * 2)))


def _stack_state(sm: ShardedModel, kept: list, g: int) -> list:
    """Grids of each shard's layer-stacked prefill k, v, ssm and conv of
    data group ``g`` (``kept`` as ``run_full`` returns it; None for a shard
    without heads of that kind or without layers)."""
    grids = []
    for j in range(4):
        parts = [[None] * sm.tp for _ in range(sm.pp)]
        for pi, _, layers in sm.stages():
            for mi in range(sm.tp):
                ts = [kept[layer][g][j][mi] for layer in layers]
                if ts[0] is not None:
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


# --------------------------------------------------------------------------
# Plans with a data axis: train, prefill and decode.
# --------------------------------------------------------------------------


@dataclasses.dataclass
class PlanModel:
    """A model cut by a train, prefill or decode plan over a plan mesh
    ((data, model) or (pod, data, model)): ``shards[row][mi]`` is the
    parameter dict of flat batch index ``row`` and model index ``mi``
    (``launch.sharding.shard_params``).  ``views`` gives each data group
    a ``ShardedModel`` over its row of the mesh, whose fsdp leaves gather
    their rows from the group's data peers (``FsdpLeaf``); the executors
    below run the groups layer by layer together (see the module
    docstring)."""
    cfg: ModelConfig
    plan: ShardingPlan
    mesh: object                      # launch.mesh.Mesh
    shards: list                      # [rows][tp] parameter dicts
    heads: list
    ssm_heads: list
    vocab: list
    local_cfgs: list

    @classmethod
    def build(cls, params, cfg: ModelConfig, plan: ShardingPlan, mesh
              ) -> "PlanModel":
        """Cut ``params`` (padded to ``cfg`` in "pad" mode)."""
        return cls.from_shards(shard_params(params, cfg, plan, mesh), cfg,
                               plan, mesh)

    @classmethod
    def from_shards(cls, shards, cfg: ModelConfig, plan: ShardingPlan, mesh
                    ) -> "PlanModel":
        heads = attn_layout(cfg, plan.rules, mesh.tp)
        ssm = ssm_layout(cfg, plan.rules, mesh.tp)
        return cls(cfg, plan, mesh, shards, heads, ssm,
                   split_ranges(cfg.padded_vocab(), mesh.tp),
                   [local_config(cfg, h, s) for h, s in zip(heads, ssm)])

    @property
    def groups(self) -> int:
        return n_groups(self.plan, self.mesh)

    def rows_of(self, g: int) -> list[int]:
        """The grid rows holding group ``g``'s batch rows: its own, or
        every row where the plan does not shard the batch."""
        return [g] if self.groups > 1 else list(range(self.mesh.n_batch))

    def peers(self, row: int) -> list[int]:
        """The rows whose fsdp parts row ``row`` gathers: the data rows of
        its pod, in data order."""
        d = int(self.mesh.batch_coord(row).get("data", 0))
        return [row - d + i for i in range(self.mesh.axis_size("data"))]

    def views(self, trees=None, dtype=None) -> list:
        """One ``ShardedModel`` per data group over its row of the mesh.
        ``trees[g]`` is the [rows][tp] grid group g reads (default: the
        shards; the trainer passes each group its own aliases, so that
        every group's gradients come out apart); ``dtype`` casts the fp32
        leaves of two or more axes, as ``cast_for_compute`` does (fsdp
        leaves after each gather)."""
        specs = param_pspecs(self.cfg, self.plan)
        fsdp = (self.plan.rules["fsdp"] is not None
                and self.mesh.axis_size("data") > 1)
        out = []
        for g in range(self.groups):
            grid = self.shards if trees is None else trees[g]
            peers = self.peers(g)

            def view(tree, spec, peer_trees, dev):
                res = {}
                for k, v in tree.items():
                    if isinstance(v, dict):
                        res[k] = view(v, spec[k], [t[k] for t in peer_trees],
                                      dev)
                        continue
                    cast = (dtype if dtype is not None and v.ndim >= 2
                            and v.dtype == torch.float32 else None)
                    if fsdp and "data" in spec[k]:
                        res[k] = FsdpLeaf([t[k] for t in peer_trees],
                                          spec[k].index("data"), dev, cast)
                    else:
                        res[k] = v if cast is None else v.to(cast)
                return res

            row = [view(grid[g][mi], specs, [grid[b][mi] for b in peers]
                        if fsdp else [], self.mesh.at(g, mi))
                   for mi in range(self.mesh.tp)]
            rmesh = ReplicaMesh(np.asarray(self.mesh.group(g),
                                           dtype=object).reshape(1, -1))
            out.append(ShardedModel(self.cfg, self.plan, rmesh, [row],
                                    [(0, self.cfg.n_layers)], self.heads,
                                    self.ssm_heads, self.vocab,
                                    self.local_cfgs))
        return out


def run_full(views: list, tokens: list | None = None,
             embeds: list | None = None, *, act_seq: bool = False,
             keep: bool = False, remat: bool = False,
             with_aux: bool = False, last_only: bool = False):
    """The full-sequence pass of every data group (``views``: one, a
    serving replica's, for ``forward`` and ``prefill``), stage by stage
    and layer by layer together: per group its tokens [B_g, S] (or embeds
    [B_g, S, d]) -> (logits per group, [B_g, S, Vpad] fp32 or with
    ``last_only`` the last position's [B_g, Vpad]; the MoE load-balance
    loss summed over the layers and divided by their count, 0 without MoE
    or ``with_aux``; with ``keep`` per layer and per group the [k, v, ssm,
    conv] lists of each shard's prefill state, ``_stack_state`` stacks
    them).

    ``act_seq`` keeps the residual between layers split along the
    sequence over the model shards (``_mixer``); ``remat`` recomputes each
    layer in the backward (``torch.utils.checkpoint``, non-reentrant) as
    ``models.forward`` does.  Differentiable: the prefill and SSD chunk
    kernels sit in ``autograd.Function``s on the card."""
    cfg = views[0].cfg
    first = views[0].mesh.first
    xss, poss = [], []
    for g, sm in enumerate(views):
        dev = sm.mesh.first
        ids = None if tokens is None else _on(tokens[g], dev)
        emb = None if embeds is None else _on(embeds[g], dev)
        B, S = (ids if ids is not None else emb).shape[:2]
        pos = _positions(B, S, dev)
        x = (_embed(sm, ids, pos) if ids is not None
             else embed_inputs(sm.shards[0][0], cfg, None, emb, pos))
        xss.append(_split_seq(x, sm) if act_seq else [x])
        poss.append(pos)
    counts = [len(xs) for xs in xss]
    aux_sum = torch.zeros((), dtype=torch.float32, device=first)
    kept = []
    for pi, _, layers in views[0].stages():
        # the hop to the stage: slice m (or the one residual) to (pi, m)
        xss = [[_on(x, sm.mesh.device(pi, mi)) for mi, x in enumerate(xs)]
               for sm, xs in zip(views, xss)]
        for layer in layers:
            local = layer - views[0].layers[pi][0]
            is_local = cfg.local_is_local(layer)

            def body(*flat, pi=pi, local=local, is_local=is_local):
                it = iter(flat)
                xss_in = [[next(it) for _ in range(n)] for n in counts]
                aux = [] if with_aux and cfg.is_moe else None
                caches = [[[None] * sm.tp for _ in range(4)] for sm in views]
                mixed = []
                for sm, xs, pos, c in zip(views, xss_in, poss, caches):
                    def attend(mi, h, p, lcfg, pos=pos, c=c):
                        out, k, v = attn_lib.full_attention(
                            h, p, lcfg, _on(pos, h.device), is_local)
                        c[0][mi], c[1][mi] = k, v
                        return out

                    def scan(mi, h, p, lcfg, c=c):
                        yg, state, conv = ssm_lib.ssm_scan(h, p, lcfg)
                        c[2][mi], c[3][mi] = state, conv
                        return yg

                    mixed.append(_mixer(
                        sm, pi, local, xs,
                        lambda h, sm=sm, f=attend: _shard_attn(sm, pi, local,
                                                               h, f),
                        lambda h, sm=sm, f=scan: _ssm(sm, pi, local, h, f)))
                out = _ffn(views, pi, local, mixed, aux)
                a = aux[0] if aux else torch.zeros_like(aux_sum)
                return tuple(x for xs in out for x in xs) + (a,), caches

            flat = tuple(x for xs in xss for x in xs)
            if remat:
                res = torch.utils.checkpoint.checkpoint(
                    lambda *f, body=body: body(*f)[0], *flat,
                    use_reentrant=False)
            else:
                res, caches = body(*flat)
                if keep:
                    kept.append(caches)
            it = iter(res[:-1])
            xss = [[next(it) for _ in range(n)] for n in counts]
            aux_sum = aux_sum + _on(res[-1], first)
    logits = []
    for sm, xs in zip(views, xss):
        x = _gather_seq(xs, sm.mesh.device(sm.pp - 1, 0))
        logits.append(_logits(sm, x[:, -1:, :])[:, 0] if last_only
                      else _logits(sm, x))
    return logits, aux_sum / cfg.n_layers, kept


def forward_plan(pm: PlanModel, tokens: list | None = None,
                 embeds: list | None = None) -> list:
    """The train plan's forward (``models.forward``): per data group its
    tokens [B_g, S] (``launch.sharding.shard_batch``) -> its logits
    [B_g, S, Vpad] fp32; the residual is sequence-parallel where the plan
    says ``act_seq``."""
    return run_full(pm.views(), tokens, embeds,
                    act_seq=pm.plan.rules["act_seq"] is not None)[0]


def prefill_plan(pm: PlanModel, tokens: list):
    """The prefill plan (``models.prefill``, batch over data, heads over
    model): per data group its tokens [B_g, S] -> (per group its last
    position's logits [B_g, Vpad] fp32, the ``DecodeCache`` at length S
    in ``cache_pspecs``'s layout, as ``launch.sharding.shard_cache`` lays
    it out: fields ``ShardGrid``s of [rows][tp] parts)."""
    from repro_torch.models.model import DecodeCache
    cfg, mesh = pm.cfg, pm.mesh
    views = pm.views()
    logits, _, kept = run_full(views, tokens, keep=True, last_only=True)
    parts = {n: [None] * mesh.n_batch for n in ("k", "v", "ssm", "conv",
                                                "pos")}
    for g, sm in enumerate(views):
        B, S = tokens[g].shape
        rows = _group_cache(sm, _stack_state(sm, kept, g), B, S)
        for row in pm.rows_of(g):
            cut = cut_cache_rows(rows, cfg, pm.plan, mesh, row)
            for n in parts:
                parts[n][row] = cut[n]
    return logits, DecodeCache(*(None if parts[n][0] is None
                                 else ShardGrid(parts[n])
                                 for n in ("k", "v", "ssm", "conv", "pos")))


def _group_cache(sm: ShardedModel, grids: list, B: int, S: int):
    """One group's prefill state with every head (``DecodeCache`` rows of
    [L, B_g, ...] on the group's first device) from its shards' stacked
    k, v, ssm and conv (``_stack_state``): each KV head and SSM head from
    the first shard that holds it, the conv windows' xs columns from each
    SSM shard and their B/C tail from the first."""
    from repro_torch.models.model import DecodeCache
    cfg = sm.cfg
    dev = sm.mesh.first
    ks, vs, ss, cs = (grid.parts[0] for grid in grids)
    k = v = ssm = conv = None
    if cfg.has_attn:
        k0 = ks[sm.attn_shards()[0]]
        k = torch.empty((k0.shape[0], B, S, cfg.n_kv_heads, cfg.head_dim),
                        dtype=k0.dtype, device=dev)
        v = torch.empty_like(k)
        for mi in reversed(sm.attn_shards()):
            kv0, kv1 = sm.heads[mi][2:]
            k[:, :, :, kv0:kv1] = _on(ks[mi], dev)
            v[:, :, :, kv0:kv1] = _on(vs[mi], dev)
    if cfg.has_ssm:
        P, d_in = cfg.ssm_head_dim, cfg.d_inner
        s0, c0 = ss[sm.ssm_shards()[0]], cs[sm.ssm_shards()[0]]
        ssm = torch.empty((s0.shape[0], B, cfg.ssm_heads, P, cfg.ssm_state),
                          dtype=s0.dtype, device=dev)
        conv = torch.empty((*c0.shape[:3], ssm_lib.conv_channels(cfg)),
                           dtype=c0.dtype, device=dev)
        for mi in reversed(sm.ssm_shards()):
            h0, h1 = sm.ssm_heads[mi]
            w = (h1 - h0) * P
            ssm[:, :, h0:h1] = _on(ss[mi], dev)
            conv[..., h0 * P:h1 * P] = _on(cs[mi][..., :w], dev)
            conv[..., d_in:] = _on(cs[mi][..., w:], dev)
    return DecodeCache(k, v, ssm, conv,
                       torch.full((B,), S, dtype=torch.int32, device=dev))


def seq_shards(pm: PlanModel, cache, g: int) -> list:
    """Group ``g``'s sequence shards of a decode-plan cache: (row, mi,
    s0, s1) of every coordinate holding a non-empty range [s0, s1) of its
    rows' positions (``kv_seq`` over ``model``, or at batch 1 over (data,
    model)), in shard order."""
    entry = pm.plan.rules["kv_seq"]
    coords = [(row, mi) for row in pm.rows_of(g) for mi in range(pm.mesh.tp)]
    shards = {}
    for row, mi in coords:
        idx = axis_index(entry, pm.mesh, row, mi)[0]
        shards.setdefault(idx, (row, mi, cache.k.parts[row][mi].shape[2]))
    out, s0 = [], 0
    for idx in sorted(shards):
        row, mi, n = shards[idx]
        if n:
            out.append((row, mi, s0, s0 + n))
        s0 += n
    return out


def _write_owned(c: torch.Tensor, new: torch.Tensor, pos: torch.Tensor,
                 s0: int, s1: int) -> None:
    """Write each row's new K or V [B, Hkv, D] at its position ``pos``
    into the shard ``c`` [B, s1 - s0, Hkv, D] holding positions [s0, s1)
    where it owns that position; the other rows keep their values."""
    rows = torch.arange(c.shape[0], device=c.device)
    own = (pos >= s0) & (pos < s1)
    idx = torch.clamp(pos.long() - s0, 0, s1 - s0 - 1)
    new = _on(new, c.device).to(c.dtype)
    c.index_put_((rows, idx), torch.where(own[:, None, None], new,
                                          c[rows, idx]))


def _combine_partials(outs: list, lses: list, device: torch.device
                      ) -> torch.Tensor:
    """The sequence shards' attention outputs [B, Hq, D] combined by their
    log-sum-exps [B, Hq] in shard order on ``device``: out = sum_j w_j
    out_j / sum_j w_j with w_j = exp(lse_j - max lse) (0 where a shard
    attended nothing), in fp32; zeros where no shard attended anything.
    One shard's output is returned as it is."""
    if len(outs) == 1:
        return outs[0]
    lse = torch.stack([_on(l, device) for l in lses])
    top = lse.amax(0)
    w = torch.where(lse > -torch.inf, torch.exp(lse - top),
                    torch.zeros_like(lse))
    acc = _reduce([w[j][..., None] * _on(o, device).float()
                   for j, o in enumerate(outs)], device)
    den = _reduce(list(w), device)
    out = torch.where(den[..., None] > 0,
                      acc / torch.clamp(den, min=1e-30)[..., None],
                      torch.zeros_like(acc))
    return out.to(outs[0].dtype)


def _decode_attn(sm: ShardedModel, layer: int, h: torch.Tensor,
                 pos: torch.Tensor, cache, shards: list, is_local: bool
                 ) -> torch.Tensor:
    """The decode plan's attention (the partial-softmax reduction point):
    each attention shard projects its query heads and every KV head; the
    query heads are gathered; each sequence shard writes the new K/V
    where it owns ``pos`` and runs B3 with its log-sum-exp over its own
    range, ``lens``/``start`` shifted and clipped into its coordinates;
    the partials are combined in shard order on the group's first device
    and each attention shard multiplies its heads' part by its ``wo``
    rows, summed as point 2 sums them."""
    cfg = sm.cfg
    B, dev = h.shape[0], h.device
    ps, qs, kvs = {}, [], {}
    for mi in sm.attn_shards():
        p = ps[mi] = layer_params(sm.shards[0][mi]["blocks"]["attn"], layer)
        hh = _on(h, p["wq"].device)
        q, k_new, v_new = attn_lib._project_qkv(
            hh, p, sm.local_cfgs[mi], _on(pos, hh.device)[:, None])
        qs.append(_on(q, dev))
        kvs[mi] = (k_new[:, 0], v_new[:, 0])
    q = (qs[0] if len(qs) == 1 else torch.cat(qs, dim=2))[:, 0]
    lens, start = attn_lib._decode_window(pos, cfg, is_local)
    outs, lses = [], []
    for row, mi, s0, s1 in shards:
        kc = cache.k.parts[row][mi][layer]
        vc = cache.v.parts[row][mi][layer]
        d = kc.device
        k_new, v_new = kvs.get(mi, kvs[min(kvs)])
        p_d = _on(pos, d)
        _write_owned(kc, k_new, p_d, s0, s1)
        _write_owned(vc, v_new, p_d, s0, s1)
        o, lse = ops.flash_decode(
            _on(q, d).to(kc.dtype).contiguous(), kc, vc,
            torch.clamp(_on(lens, d) - s0, 0, s1 - s0),
            torch.clamp(_on(start, d) - s0, 0, s1 - s0),
            softcap=float(cfg.attn_logit_softcap), with_lse=True)
        outs.append(o)
        lses.append(lse)
    out = _combine_partials(outs, lses, dev).to(h.dtype)
    parts = []
    for mi in sm.attn_shards():
        q0, q1 = sm.heads[mi][:2]
        wo = ps[mi]["wo"]
        parts.append(_on(out[:, q0:q1], wo.device).reshape(
            B, 1, (q1 - q0) * cfg.head_dim) @ wo)
    return _reduce(parts, dev)


def decode_step_plan(pm: PlanModel, tokens: list, cache):
    """One token for every sequence (``models.decode_step``) against a
    cache in the decode plan's layout (``launch.sharding.shard_cache`` or
    ``reshard_cache``), updated in place: per data group its tokens [B_g]
    -> (per group its logits [B_g, Vpad] fp32, the cache with pos + 1).

    The cache is split along its sequence (``kv_seq``): over ``model``, or
    at batch 1 over (data, model), where the data axis splits the
    sequence of the one group that computes.  SSM rows follow
    ``ssm_heads``; each SSM shard steps its own heads from its conv
    window's columns and the B/C tail, and writes them back (and into the
    replicas the layout keeps) once every shard of the layer has read."""
    cfg, mesh = pm.cfg, pm.mesh
    views = pm.views()
    P, d_in = cfg.ssm_head_dim, cfg.d_inner
    # SSM heads split over model (each shard its own), or every shard a
    # replica of all of them
    split_heads = pm.plan.rules["ssm_heads"] == "model"
    state = []
    for g, sm in enumerate(views):
        dev = sm.mesh.first
        pos = _on(cache.pos.parts[pm.rows_of(g)[0]][0], dev)
        x = _embed(sm, _on(tokens[g], dev)[:, None], pos[:, None])
        state.append((pos, x, seq_shards(pm, cache, g) if cfg.has_attn
                      else []))
    for layer in range(cfg.n_layers):
        is_local = cfg.local_is_local(layer)
        mixed = []
        for g, (sm, (pos, x, shards)) in enumerate(zip(views, state)):
            row0 = pm.rows_of(g)[0]
            pending = []

            def scan(mi, h, p, lcfg, row0=row0, g=g, pending=pending):
                h0, h1 = sm.ssm_heads[mi]
                st = cache.ssm.parts[row0][mi][layer]
                cv = cache.conv.parts[row0][mi][layer]
                if (h0, h1) != (0, cfg.ssm_heads):
                    cv = torch.cat([cv[..., h0 * P:h1 * P], cv[..., d_in:]],
                                   dim=-1)
                yg, new_st, new_cv = ssm_lib.ssm_decode_scan(h, p, lcfg, st,
                                                             cv)

                def write():
                    w = (h1 - h0) * P
                    for row in pm.rows_of(g):
                        for m2 in range(mesh.tp):
                            s2 = cache.ssm.parts[row][m2][layer]
                            if m2 == mi or not split_heads:
                                s2.copy_(_on(new_st, s2.device))
                            c2 = cache.conv.parts[row][m2][layer]
                            c2[..., h0 * P:h1 * P] = _on(new_cv[..., :w],
                                                         c2.device)
                            c2[..., d_in:] = _on(new_cv[..., w:], c2.device)
                pending.append(write)
                return yg[:, None]

            mixed.append(_mixer(
                sm, 0, layer, [x],
                lambda h, sm=sm, pos=pos, shards=shards: _decode_attn(
                    sm, layer, h, pos, cache, shards, is_local),
                lambda h, sm=sm, f=scan: _ssm(sm, 0, layer, h, f)))
            for write in pending:
                write()
        out = _ffn(views, 0, layer, mixed)
        state = [(pos, xs[0], shards)
                 for (pos, _, shards), xs in zip(state, out)]
    logits = [_logits(sm, x)[:, 0] for sm, (_, x, _) in zip(views, state)]
    return logits, dataclasses.replace(cache,
                                       pos=cache.pos.map(lambda t: t + 1))
