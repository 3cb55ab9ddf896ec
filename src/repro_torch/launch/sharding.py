"""Sharding rules: logical axes -> mesh axes, per architecture and mode
(the JAX package's ``launch/sharding.py``), and the slicing of a
parameter tree into one replica's shards.

The plan and spec functions are pure functions of the config, copied from
the JAX package so their results compare entry by entry:
  * MLP d_ff / vocab / experts over `model`;
  * attention by heads when divisible, padded heads ("pad") or replicated
    ("replicate") otherwise; KV-head sharding only when divisible;
  * decode KV caches sequence-sharded over `model` (flash-decoding);
  * batch over (`pod`, `data`); long_500k (batch=1) shards the KV sequence
    over (`data`, `model`) instead;
  * optional FSDP row-sharding of parameters over `data`.

Where JAX places a tree with ``NamedSharding``s and lets GSPMD partition
the program, the port slices it explicitly: ``shard_params`` gives every
(pipe, model) coordinate of a replica mesh its own parameter dict, on its
own device, which ``repro_torch.models.sharded`` runs.  The attention
leaves follow ``attn_layout``: a shard holds the query heads the plan gives
it and the KV heads those heads read.  That is the spec's split where KV
heads divide tp; where the spec replicates KV heads over `model`, each
shard keeps only the KV-head range its query heads use, so the kernels see
a contiguous pool of exactly those heads; in "replicate" mode the first
model shard holds every head and the others none.  The SSM leaves follow
``ssm_layout`` the same way: whole SSM heads over `model` where they
divide tp, else every head on the first shard; B/C stay whole on every
shard.  MoE leaves are cut by their specs: experts over `model` ("ep"), or
each expert's ff axis ("tp").
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.launch.mesh import ReplicaMesh
from repro_torch.models.config import ModelConfig
from repro_torch.pshard import P


@dataclasses.dataclass(frozen=True)
class ShardingPlan:
    rules: dict                  # logical activation axis -> mesh axes
    fsdp: bool                   # row-shard params over data
    attn_mode: str               # heads | pad | replicate
    tp: int                      # size of the model axis

    def describe(self) -> str:
        return (f"attn={self.attn_mode} fsdp={self.fsdp} "
                + " ".join(f"{k}:{v}" for k, v in sorted(
                    self.rules.items(), key=lambda kv: kv[0])
                    if v is not None))


def _divisible(n: int, tp: int) -> bool:
    return n > 0 and n % tp == 0


def resolve_attn_mode(cfg: ModelConfig, tp: int) -> str:
    mode = cfg.attn_sharding
    if mode == "auto":
        if _divisible(cfg.n_q_heads, tp):
            return "heads"
        padded = pad_heads(cfg, tp)
        if padded is not None and padded[0] <= 2 * cfg.n_q_heads:
            return "pad"
        return "replicate"
    if mode == "heads" and not _divisible(cfg.n_q_heads, tp):
        return "pad" if pad_heads(cfg, tp) else "replicate"
    if mode == "pad" and pad_heads(cfg, tp) is None:
        # no function-preserving padding below the 4x bound: an explicit
        # "pad" must degrade too, or the plan would shard unpadded heads
        return "replicate"
    return mode


def pad_heads(cfg: ModelConfig, tp: int) -> tuple[int, int] | None:
    """(padded_q_heads, padded_kv_heads) preserving the GQA group mapping.

    MHA: pad q and kv together.  GQA: pad heads-per-group so kv*g' % tp == 0.
    Returns None if no preserving padding exists below 4x.
    """
    q, kv = cfg.n_q_heads, cfg.n_kv_heads
    if q == kv:
        qp = ((q + tp - 1) // tp) * tp
        if qp > 4 * q:
            return None     # tp so large the pad would exceed the 4x bound
        return (qp, qp)
    g = q // kv
    gp = g
    while kv * gp <= 4 * q:      # same 4x bound as the MHA branch
        if (kv * gp) % tp == 0:
            return (kv * gp, kv)
        gp += 1
    return None


def padded_config(cfg: ModelConfig, tp: int) -> ModelConfig:
    """Apply head padding for 'pad' mode (identity function preserved by
    zero-padding weights; see pad_attention_params)."""
    res = pad_heads(cfg, tp)
    if res is None:
        return cfg
    qp, kvp = res
    if qp == cfg.n_q_heads and kvp == cfg.n_kv_heads:
        return cfg
    return dataclasses.replace(cfg, n_q_heads=qp, n_kv_heads=kvp)


def make_plan(cfg: ModelConfig, shape_kind: str, multi_pod: bool,
              global_batch: int, tp: int = 16, fsdp: bool | None = None,
              pp: int = 1) -> tuple[ShardingPlan, ModelConfig]:
    """Returns (plan, possibly-padded config).

    ``shape_kind="serve"`` is the paged serving-replica mode: KV pools are
    head-sharded over ``model`` (never sequence-sharded — pages are the
    storage unit), batch stays host-scheduled (unsharded), and ``pp > 1``
    shards the layer-stacked parameter/pool leading axis over ``pipe``
    (see ``launch.mesh.make_replica_mesh``).
    """
    batch_axes = ("pod", "data") if multi_pod else ("data",)
    attn_mode = resolve_attn_mode(cfg, tp)
    run_cfg = padded_config(cfg, tp) if attn_mode == "pad" else cfg

    heads = "model" if attn_mode in ("heads", "pad") else None
    kv_heads = ("model" if attn_mode in ("heads", "pad")
                and _divisible(run_cfg.n_kv_heads, tp) else None)

    if fsdp is None:
        # FSDP (row-shard params over `data`) only when TP-only sharding
        # cannot leave headroom: train state = fp32 params + adam m/v +
        # fp32 grads = 16 B/param; serving = bf16 weights
        if shape_kind == "train":
            fsdp = True
        else:
            fsdp = cfg.param_count() * 2 / tp > 9e9

    expert_mode = cfg.expert_sharding
    if expert_mode == "auto":
        expert_mode = "ep" if _divisible(cfg.n_experts, tp) else "tp"

    rules = {
        "batch": batch_axes if global_batch > 1 else None,
        "seq": None,
        "heads": heads,
        "kv_heads": kv_heads,
        "d_ff": "model",
        "d_model": None,
        "vocab": "model",
        "experts": "model" if expert_mode == "ep" else None,
        "expert_ff": "model" if expert_mode == "tp" else None,
        "moe_groups": batch_axes if global_batch > 1 else None,
        "ssm_heads": "model" if _divisible(cfg.ssm_heads, tp) else None,
        "kv_seq": None,
        # sequence-parallel residual stream for training: layer-boundary
        # activations shard over `model`; per-arch opt-out
        "act_seq": ("model" if shape_kind == "train" and cfg.seq_parallel
                    else None),
        "fsdp": "data" if fsdp else None,
        # layer-stacked leading axis of params / paged pools (pipeline
        # parallelism inside a serving replica); an indivisible layer count
        # replicates across `pipe` instead of failing placement
        "layers": ("pipe" if pp > 1 and cfg.n_layers % pp == 0 else None),
    }
    if shape_kind == "serve":
        # serving replica: batch is host-scheduled, KV pools shard by head,
        # never by sequence
        rules["batch"] = None
        rules["moe_groups"] = None
        rules["fsdp"] = None
        return ShardingPlan(rules, False, attn_mode, tp), run_cfg
    if shape_kind == "decode":
        if global_batch == 1:
            # long-context single sequence: shard the KV sequence everywhere
            rules["kv_seq"] = tuple(a for a in (*batch_axes, "model"))
        else:
            rules["kv_seq"] = "model"
        # the cache sequence axis owns `model`; KV heads replicate at decode
        rules["kv_heads"] = None
    return ShardingPlan(rules, fsdp, attn_mode, tp), run_cfg


# --------------------------------------------------------------------------
# Parameter / cache / pool PartitionSpecs.
# --------------------------------------------------------------------------


def param_pspecs(cfg: ModelConfig, plan: ShardingPlan):
    """Tree of ``P`` mirroring ``init_params(cfg)``."""
    r = plan.rules
    row = r["fsdp"]   # None or "data"
    layers = r.get("layers")   # None, or "pipe" for pp-sharded replicas

    def blocks(spec: P) -> P:
        return P(layers, *spec)  # layer-stacked leading dim

    b: dict = {"ln1": blocks(P(None))}
    if cfg.has_attn:
        attn = {
            "wq": blocks(P(row, r["heads"])),
            "wk": blocks(P(row, r["kv_heads"])),
            "wv": blocks(P(row, r["kv_heads"])),
            "wo": blocks(P(r["heads"], row)),
        }
        if cfg.qkv_bias:
            attn["bq"] = blocks(P(r["heads"]))
            attn["bk"] = blocks(P(r["kv_heads"]))
            attn["bv"] = blocks(P(r["kv_heads"]))
        if cfg.qk_norm:
            attn["q_norm"] = blocks(P(None))
            attn["k_norm"] = blocks(P(None))
        b["attn"] = attn
    if cfg.has_ssm:
        sh = r["ssm_heads"]
        b["ssm"] = {
            "w_z": blocks(P(row, sh)), "w_x": blocks(P(row, sh)),
            "w_B": blocks(P(row, None)), "w_C": blocks(P(row, None)),
            "w_dt": blocks(P(row, sh)),
            "conv_x": blocks(P(None, sh)),
            "conv_B": blocks(P(None, None)), "conv_C": blocks(P(None, None)),
            "conv_b": blocks(P(None)),
            "dt_bias": blocks(P(sh)), "A_log": blocks(P(sh)),
            "D": blocks(P(sh)), "norm_w": blocks(P(sh)),
            "out_proj": blocks(P(sh, row)),
        }
    if cfg.hybrid:
        b["attn_out_norm"] = blocks(P(None))
        b["ssm_out_norm"] = blocks(P(None))
    if cfg.sandwich_norm:
        b["post_ln1"] = blocks(P(None))
    if cfg.is_moe:
        e, eff = r["experts"], r["expert_ff"]
        b["ln2"] = blocks(P(None))
        b["moe"] = {
            "router": blocks(P(row, None)),
            "w_gate": blocks(P(e, row, eff)),
            "w_up": blocks(P(e, row, eff)),
            "w_down": blocks(P(e, eff, row)),
        }
    elif cfg.d_ff > 0:
        b["ln2"] = blocks(P(None))
        mlp = {
            "w_gate": blocks(P(row, r["d_ff"])),
            "w_up": blocks(P(row, r["d_ff"])),
            "w_down": blocks(P(r["d_ff"], row)),
        }
        if cfg.mlp_variant == "gelu":
            del mlp["w_gate"]
        if cfg.mlp_bias:
            mlp["b_up"] = blocks(P(r["d_ff"]))
            mlp["b_down"] = blocks(P(None))
        b["mlp"] = mlp
    if cfg.sandwich_norm and (cfg.is_moe or cfg.d_ff > 0):
        b["post_ln2"] = blocks(P(None))

    specs = {
        "embed": P(r["vocab"], None),
        "blocks": b,
        "final_norm": P(None),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = P(row, r["vocab"])
    return specs


def opt_pspecs(param_specs):
    return {"m": param_specs, "v": param_specs, "step": P()}


def cache_pspecs(cfg: ModelConfig, plan: ShardingPlan):
    """``P``s for a ``DecodeCache``."""
    from repro_torch.models.model import DecodeCache
    r = plan.rules
    layers = r.get("layers")
    k = v = ssm = conv = None
    if cfg.has_attn:
        k = P(layers, r["batch"], r["kv_seq"], r["kv_heads"], None)
        v = k
    if cfg.has_ssm:
        ssm = P(layers, r["batch"], r["ssm_heads"], None, None)
        conv = P(layers, r["batch"], None, None)
    return DecodeCache(k=k, v=v, ssm=ssm, conv=conv, pos=P(r["batch"]))


def pool_pspecs(cfg: ModelConfig, plan: ShardingPlan) -> P | None:
    """``P`` for one paged K/V ``BlockPool`` array.

    Pool layout is ``[L, num_blocks + 1, Hkv, page, D]`` (kernel-native):
    the layer axis shards over ``pipe`` (pp), the KV-head axis over
    ``model`` (tp, when divisible), and pages/positions stay whole — block
    tables address a head-sharded pool exactly like an unsharded one, which
    is what keeps the host allocator and the migration page-handoff path
    oblivious to sharding.
    """
    if not cfg.has_attn:
        return None
    r = plan.rules
    return P(r.get("layers"), None, r["kv_heads"], None, None)


# --------------------------------------------------------------------------
# Head padding for parameters (function-preserving).
# --------------------------------------------------------------------------


def pad_attention_params(params, cfg: ModelConfig, padded: ModelConfig):
    """Zero-pad q (and kv) head weights so the padded model computes the
    identical function: padded q-head rows of wo are zero, padded kv heads
    are only attended by padded q heads.

    Real heads keep their GQA group: group g occupies slots
    [g*gp, g*gp + g_real) in the padded layout.  New tensors; the input
    tree is not changed.
    """
    if (padded.n_q_heads == cfg.n_q_heads
            and padded.n_kv_heads == cfg.n_kv_heads):
        return params
    D = cfg.head_dim
    q_old, q_new = cfg.n_q_heads, padded.n_q_heads
    kv_old, kv_new = cfg.n_kv_heads, padded.n_kv_heads
    if kv_new != kv_old:
        # MHA: kv pads together with q, so the whole head axis is ONE group
        # — real heads keep slots [0, q_old) and padded q/kv heads pair up
        # at the tail (the wk/wv pad below appends kv zeros at the end)
        groups, per_old, per_new = 1, q_old, q_new
    else:
        # GQA: kv heads unchanged; pad heads-per-group inside each group
        groups, per_old, per_new = kv_old, q_old // kv_old, q_new // kv_new

    def scatter_cols(w):
        # w: [..., q_old*D] -> [..., q_new*D] group-aware
        shape = w.shape[:-1]
        w = w.reshape(*shape, groups, per_old, D)
        out = w.new_zeros((*shape, groups, per_new, D))
        out[..., :per_old, :] = w
        return out.reshape(*shape, q_new * D)

    def pad_kv(w):
        w = w.reshape(*w.shape[:-1], kv_old, D)
        out = w.new_zeros((*w.shape[:-2], kv_new, D))
        out[..., :kv_old, :] = w
        return out.reshape(*w.shape[:-2], kv_new * D)

    a = dict(params["blocks"]["attn"])
    a["wq"] = scatter_cols(a["wq"])
    a["wo"] = scatter_cols(a["wo"].transpose(-1, -2)).transpose(-1, -2)
    if "bq" in a:
        a["bq"] = scatter_cols(a["bq"])
    if kv_new != kv_old:
        for name in ("wk", "wv", "bk", "bv"):
            if name in a:
                a[name] = pad_kv(a[name])
    new_blocks = dict(params["blocks"])
    new_blocks["attn"] = a
    return {**params, "blocks": new_blocks}


# --------------------------------------------------------------------------
# The port's explicit shards.
# --------------------------------------------------------------------------


def split_ranges(n: int, parts: int) -> list[tuple[int, int]]:
    """``torch.tensor_split``'s ranges of an axis of ``n`` into ``parts``:
    the first ``n % parts`` ranges one longer, none padded."""
    base, extra = divmod(n, parts)
    out, lo = [], 0
    for i in range(parts):
        hi = lo + base + (1 if i < extra else 0)
        out.append((lo, hi))
        lo = hi
    return out


def layer_layout(n_layers: int, rules: dict, pp: int
                 ) -> list[tuple[int, int]]:
    """Each pipeline stage's layer range [l0, l1).  Layers over ``pipe``
    split evenly; an indivisible count (``layers`` unsharded) stays whole
    on stage 0 and the later stages hold none."""
    L = n_layers
    if rules.get("layers") == "pipe":
        return split_ranges(L, pp)
    return [(0, L)] + [(L, L)] * (pp - 1)


def attn_layout(cfg: ModelConfig, rules: dict, tp: int
                ) -> list[tuple[int, int, int, int]]:
    """Each model shard's heads ``(q0, q1, kv0, kv1)``: query heads
    [q0, q1) and the KV heads [kv0, kv1) those read (query head h reads KV
    head h // group).  Heads over ``model`` split evenly; in "replicate"
    mode shard 0 holds every head and the others none.  Raises where a
    shard's heads would not form whole local groups (no config of the
    repo at a power-of-two tp does)."""
    Hq, Hkv = cfg.n_q_heads, cfg.n_kv_heads
    if not cfg.has_attn:
        return [(0, 0, 0, 0)] * tp
    if rules["heads"] != "model":
        return [(0, Hq, 0, Hkv)] + [(Hq, Hq, Hkv, Hkv)] * (tp - 1)
    if rules.get("kv_seq") is not None:
        # the decode plan: the cache is split by sequence and every shard
        # projects and attends every KV head (its query heads are gathered
        # before attending), so each holds the whole K/V projections
        return [(q0, q1, 0, Hkv) for q0, q1 in split_ranges(Hq, tp)]
    g = Hq // Hkv
    out = []
    for q0, q1 in split_ranges(Hq, tp):
        kv0, kv1 = q0 // g, (q1 - 1) // g + 1
        if (q1 - q0) % (kv1 - kv0) or any(
                (q0 + h) // g - kv0 != h // ((q1 - q0) // (kv1 - kv0))
                for h in range(q1 - q0)):
            raise ValueError(
                f"{cfg.name}: query heads [{q0}, {q1}) of a group of {g} "
                f"do not form whole groups over KV heads [{kv0}, {kv1})")
        out.append((q0, q1, kv0, kv1))
    return out


def ssm_layout(cfg: ModelConfig, rules: dict, tp: int
               ) -> list[tuple[int, int]]:
    """Each model shard's SSM heads [h0, h1).  Heads over ``model`` split
    evenly; where ``ssm_heads`` is unsharded (a head count tp does not
    divide, hymba's 25) shard 0 holds every head and the others none, as
    "replicate" attention does.  A shard's heads read B/C of every group,
    which is right only with one group or one shard holding every head:
    more groups with the heads split raise ``ValueError``."""
    H = cfg.ssm_heads
    if not cfg.has_ssm:
        return [(0, 0)] * tp
    if rules["ssm_heads"] != "model":
        return [(0, H)] + [(H, H)] * (tp - 1)
    if cfg.ssm_groups > 1 and tp > 1:
        raise ValueError(
            f"{cfg.name}: ssm_groups = {cfg.ssm_groups} > 1 with its "
            f"{H} SSM heads split over {tp} model shards: a shard's heads "
            "would read the wrong groups' B/C (only one group, or "
            "ssm_heads unsharded, is supported)")
    return split_ranges(H, tp)


def local_config(cfg: ModelConfig, heads: tuple[int, int, int, int],
                 ssm: tuple[int, int] | None = None) -> ModelConfig:
    """``cfg`` with one shard's head counts, attention's and, given
    ``ssm``, the SSM's (the per-layer functions size their reshapes and
    kernel calls from them; d_inner and the conv's channels follow)."""
    q0, q1, kv0, kv1 = heads
    over = dict(n_q_heads=q1 - q0, n_kv_heads=kv1 - kv0)
    if ssm is not None:
        over["ssm_heads"] = ssm[1] - ssm[0]
    return dataclasses.replace(cfg, **over)


def _on(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` on ``device``: itself (or a view) where it is there already."""
    return t if t.device == device else t.to(device)


def _slice(t: torch.Tensor, axis: int, lo: int, hi: int) -> torch.Tensor:
    return t.narrow(axis, lo, hi - lo)


def grid_rows(mesh) -> int:
    """The rows of a mesh's shard grid: the pipeline stages of a replica
    mesh, the flat batch index (pod x data) of a plan mesh."""
    return mesh.pp if isinstance(mesh, ReplicaMesh) else mesh.n_batch


def axis_index(entry, mesh, row: int, mi: int) -> tuple[int, int]:
    """(index, count) of the shard of coordinate (``row``, ``mi``) along
    an axis with spec entry ``entry``: (0, 1) for None, else over the
    named axes, a tuple flattened first axis major (("data", "model")
    counts data x model with model minor, as JAX's spec tuples do)."""
    if entry is None:
        return 0, 1
    axes = (entry,) if isinstance(entry, str) else tuple(entry)
    coord = (mesh.batch_coord(row) if not isinstance(mesh, ReplicaMesh)
             else {"pipe": row})
    idx, size = 0, 1
    for a in axes:
        k = mesh.axis_size(a)
        i = mi if a == "model" else int(coord.get(a, 0))
        idx, size = idx * k + i, size * k
    return idx, size


def _axis_range(entry, n: int, mesh, row: int, mi: int) -> tuple[int, int]:
    """The range of an axis of ``n`` that spec entry ``entry`` gives the
    coordinate (``row``, ``mi``): ``split_ranges`` over the shards."""
    idx, size = axis_index(entry, mesh, row, mi)
    return split_ranges(n, size)[idx]


class ParamLayout:
    """Where each coordinate's slice of every parameter leaf lies in the
    logical leaf: ``ranges(path, shape, row, mi)`` is one list of (lo,
    hi) ranges per axis (two on the one axis of ``conv_b``, whose shard
    is its xs columns and the whole B/C tail; one elsewhere).

    A leaf is cut along every axis its spec puts over a mesh axis: the
    layer axis over ``pipe`` (a replica mesh's rows), the ``fsdp`` row
    axis over ``data`` (a plan mesh), ``d_ff``/``vocab``/experts over
    ``model`` by ``split_ranges`` (``torch.tensor_split``'s ranges: an
    indivisible axis gets uneven shards, never padding), the attention
    leaves by ``attn_layout`` and the SSM leaves by ``ssm_layout`` (whole
    heads: columns [h0 * P, h1 * P) of the d_inner-wide leaves, rows of
    ``out_proj``, entries of the per-head ones)."""

    def __init__(self, cfg: ModelConfig, plan: ShardingPlan, mesh):
        self.cfg, self.mesh = cfg, mesh
        self.specs = param_pspecs(cfg, plan)
        self.heads = attn_layout(cfg, plan.rules, mesh.tp)
        self.ssm_heads = ssm_layout(cfg, plan.rules, mesh.tp)

    def spec(self, path: tuple):
        s = self.specs
        for k in path:
            s = s[k]
        return s

    def ranges(self, path: tuple, shape, row: int, mi: int) -> list:
        cfg, spec = self.cfg, self.spec(path)
        kind = path[1] if len(path) == 3 else None
        name = path[-1]
        r = [[_axis_range(None if (e == "model" and kind in ("attn", "ssm"))
                          else e, n, self.mesh, row, mi)]
             for e, n in zip(spec, shape)]
        last = len(shape) - 1
        if kind == "attn":
            q0, q1, kv0, kv1 = self.heads[mi]
            D = cfg.head_dim
            if name in ("wq", "bq"):
                r[last] = [(q0 * D, q1 * D)]
            elif name == "wo":
                r[1] = [(q0 * D, q1 * D)]
            elif name in ("wk", "wv", "bk", "bv"):
                r[last] = [(kv0 * D, kv1 * D)]
        elif kind == "ssm":
            h0, h1 = self.ssm_heads[mi]
            P = cfg.ssm_head_dim
            if name in ("w_z", "w_x", "conv_x", "norm_w"):
                r[last] = [(h0 * P, h1 * P)]
            elif name in ("w_dt", "dt_bias", "A_log", "D"):
                r[last] = [(h0, h1)]
            elif name == "out_proj":
                r[1] = [(h0 * P, h1 * P)]
            elif name == "conv_b":
                r[last] = [(h0 * P, h1 * P), (cfg.d_inner, shape[last])]
        return r

    def part(self, tree, row: int, mi: int) -> dict:
        """Coordinate (row, mi)'s cut of a logical tree (parameters, or
        moments or gradients alike), views where one range an axis."""
        return tree_from_paths([
            (path, _take(t, self.ranges(path, t.shape, row, mi)))
            for path, t in leaves_with_paths(tree)])

    def add(self, out: dict, tree, row: int, mi: int) -> None:
        """Add coordinate (row, mi)'s tree into the logical leaves ``out``
        (path -> tensor), leaves of ``tree`` that are None skipped."""
        for path, t in leaves_with_paths(tree):
            if t is not None:
                _put(out[path], self.ranges(path, out[path].shape, row, mi),
                     t, add=True)


def _take(t: torch.Tensor, ranges: list) -> torch.Tensor:
    """``t`` cut to ``ranges``: a view (narrows) unless an axis has
    several ranges, which are concatenated."""
    for axis, rs in enumerate(ranges):
        if len(rs) > 1:
            t = torch.cat([_slice(t, axis, lo, hi) for lo, hi in rs],
                          dim=axis)
        elif rs[0] != (0, t.shape[axis]):
            t = _slice(t, axis, *rs[0])
    return t


def _put(out: torch.Tensor, ranges: list, part: torch.Tensor,
         add: bool = False) -> None:
    """Write (or, with ``add``, add) ``part`` into ``out`` at ``ranges``
    (``_take``'s inverse)."""
    pieces = [(ranges, part)]
    for axis, rs in enumerate(ranges):
        if len(rs) > 1:
            pieces, off = [], 0
            for lo, hi in rs:
                rr = list(ranges)
                rr[axis] = [(lo, hi)]
                pieces.append((rr, _slice(part, axis, off, off + hi - lo)))
                off += hi - lo
    for rr, pc in pieces:
        view = out
        for axis, ((lo, hi),) in enumerate(rr):
            view = _slice(view, axis, lo, hi)
        pc = _on(pc, view.device)
        if add:
            view.add_(pc)
        else:
            view.copy_(pc)


def leaves_with_paths(tree, path: tuple = ()):
    """[(path tuple, leaf)] in sorted key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in leaves_with_paths(tree[k], path + (k,))]
    return [(path, tree)]


def tree_from_paths(paths_leaves: list):
    """A nested dict from [(path tuple, leaf)]."""
    out: dict = {}
    for path, leaf in paths_leaves:
        d = out
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = leaf
    return out


def param_shapes(cfg: ModelConfig) -> dict:
    """The logical shape of every parameter leaf (``init_params`` on the
    meta device: no memory, no values)."""
    from repro_torch.models.model import init_params
    params = init_params(cfg, 0, torch.float32, "meta")
    return tree_from_paths([(p, tuple(t.shape))
                   for p, t in leaves_with_paths(params)])


def shard_params(params, cfg: ModelConfig, plan: ShardingPlan, mesh,
                 copy: bool = False):
    """Each coordinate's parameter dict, on its device: ``grid[row][mi]``,
    ``row`` the pipeline stage of a ``ReplicaMesh`` or the flat batch
    index (pod x data) of a plan ``Mesh``.  ``cfg`` is the plan's run
    config (head-padded in "pad" mode, with ``params`` padded to it by
    ``pad_attention_params``).  Leaves are cut as ``ParamLayout`` says;
    replicated leaves (norms, the router, the SSM's B/C projections and
    conv weights, and every leaf over ``data`` without fsdp) are whole.

    On the device the params live on, every slice is a view (a layer
    range, a block of rows, or a strided block of columns that ``@``
    accepts): co-located shards hold no weight copy; only ``conv_b``, one
    leaf over xs and B/C channels, becomes a small copy of the shard's xs
    columns and the whole B/C tail.  On another device a slice is copied
    there.  ``copy`` gives every coordinate its own contiguous copy (a
    train state, which the optimizer updates in place, must not share a
    replicated leaf between coordinates).
    """
    lay = ParamLayout(cfg, plan, mesh)

    def one(row, mi):
        dev = (mesh.device(row, mi) if isinstance(mesh, ReplicaMesh)
               else mesh.at(row, mi))
        out = []
        for path, part in leaves_with_paths(lay.part(params, row, mi)):
            part = _on(part, dev)
            if copy:
                part = part.clone(memory_format=torch.contiguous_format)
            out.append((path, part))
        return tree_from_paths(out)

    return [[one(row, mi) for mi in range(mesh.tp)]
            for row in range(grid_rows(mesh))]


def gather_logical(grid, cfg: ModelConfig, plan: ShardingPlan, mesh,
                   device=None) -> dict:
    """``shard_params``'s inverse: the logical tree of a grid of
    coordinate trees (parameters, or moments cut like them), on
    ``device`` (default the first coordinate's).  A replicated element
    is taken from its first holder."""
    lay = ParamLayout(cfg, plan, mesh)
    shapes = dict(leaves_with_paths(param_shapes(cfg)))
    coords = [(row, mi, dict(leaves_with_paths(grid[row][mi])))
              for row in range(len(grid)) for mi in range(mesh.tp)]
    out = []
    for path, shape in shapes.items():
        t0 = coords[0][2][path]
        t = torch.empty(shape, dtype=t0.dtype, device=device or t0.device)
        for row, mi, leaves in reversed(coords):
            _put(t, lay.ranges(path, shape, row, mi), leaves[path])
        out.append((path, t))
    return tree_from_paths(out)


def shard_train_state(state: dict, cfg: ModelConfig, plan: ShardingPlan,
                      mesh) -> dict:
    """A logical train state ``{"params", "opt": {"m", "v", "step"}}`` ->
    the sharded one: params and the moments as grids of per-coordinate
    copies cut alike (``opt_pspecs``), the step counter whole."""
    opt = state["opt"]
    return {"params": shard_params(state["params"], cfg, plan, mesh,
                                   copy=True),
            "opt": {"m": shard_params(opt["m"], cfg, plan, mesh, copy=True),
                    "v": shard_params(opt["v"], cfg, plan, mesh, copy=True),
                    "step": opt["step"]}}


def gather_train_state(state: dict, cfg: ModelConfig, plan: ShardingPlan,
                       mesh, device=None) -> dict:
    """``shard_train_state``'s inverse: the logical train state."""
    opt = state["opt"]
    return {"params": gather_logical(state["params"], cfg, plan, mesh,
                                     device),
            "opt": {"m": gather_logical(opt["m"], cfg, plan, mesh, device),
                    "v": gather_logical(opt["v"], cfg, plan, mesh, device),
                    "step": opt["step"]}}


# --------------------------------------------------------------------------
# Batches and dense decode caches over a plan mesh.
# --------------------------------------------------------------------------


def n_groups(plan: ShardingPlan, mesh) -> int:
    """The data groups that compute apart: the flat batch size of the
    mesh where the plan shards the batch, else 1 (a batch of one is
    computed once, the data axis replicating it or, in the decode plan,
    splitting its cache's sequence)."""
    return mesh.n_batch if plan.rules["batch"] is not None else 1


def batch_rows(B: int, plan: ShardingPlan, mesh) -> list[tuple[int, int]]:
    """Each data group's rows [r0, r1) of a global batch of ``B``."""
    return split_ranges(B, n_groups(plan, mesh))


def shard_batch(batch: dict, plan: ShardingPlan, mesh) -> list[dict]:
    """A batch dict (``tokens``, ``labels``, ``embeds``: leading axis the
    global batch) -> one dict per data group, its rows on the group's
    first device (``P(batch, ...)``)."""
    B = next(iter(batch.values())).shape[0]
    return [{k: _on(x[r0:r1], mesh.at(g, 0)) for k, x in batch.items()}
            for g, (r0, r1) in enumerate(batch_rows(B, plan, mesh))]


def _cache_ranges(spec, shape, mesh, row: int, mi: int,
                  rows_done: bool = False) -> list:
    """Per-axis ranges of a cache leaf of logical ``shape`` for (row,
    mi); ``rows_done`` leaves the batch axis (axis 1) whole (the leaf
    already holds only the group's rows)."""
    return [[(0, n) if (a == 1 and rows_done)
             else _axis_range(e, n, mesh, row, mi)]
            for a, (e, n) in enumerate(zip(spec, shape))]


def cut_cache_rows(cache, cfg: ModelConfig, plan: ShardingPlan, mesh,
                   row: int):
    """A logical-head cache of one data group's rows (``DecodeCache`` of
    [L, B_g, ...] tensors, pos [B_g]) -> its parts of every model
    coordinate of grid row ``row`` (the plan's kv_seq/kv_heads/ssm_heads
    cut): per field a list over the model axis of contiguous copies on
    their devices."""
    specs = cache_pspecs(cfg, plan)
    devs = mesh.group(row)
    out = {}
    for name in ("k", "v", "ssm", "conv"):
        t = getattr(cache, name)
        out[name] = None if t is None else [
            _on(_take(t, _cache_ranges(getattr(specs, name), t.shape, mesh,
                                       row, mi, rows_done=True)),
                devs[mi]).contiguous()
            for mi in range(mesh.tp)]
    out["pos"] = [cache.pos.to(d, copy=True) for d in devs]
    return out


def shard_cache(cache, cfg: ModelConfig, plan: ShardingPlan, mesh):
    """A logical ``DecodeCache`` ([L, B, S, Hkv, D] k/v, [L, B, H, P, N]
    ssm, [L, B, W - 1, conv_ch] conv, pos [B]) -> the plan's layout
    (``cache_pspecs``): a ``DecodeCache`` whose fields are ``ShardGrid``s
    of each (row, model) coordinate's contiguous part on its device.  In
    the prefill plan batch goes over the batch axes and KV heads over
    ``model``; in the decode plan the sequence goes over ``kv_seq``
    (``model``, or (data, model) at batch 1) and KV heads are whole; SSM
    rows follow ``ssm_heads`` and batch, conv windows batch."""
    from repro_torch.models.model import DecodeCache
    from repro_torch.models.sharded import ShardGrid
    specs = cache_pspecs(cfg, plan)
    parts = {name: [] for name in ("k", "v", "ssm", "conv", "pos")}
    for row in range(mesh.n_batch):
        devs = mesh.group(row)
        for name in parts:
            t = getattr(cache, name)
            if t is None:
                parts[name] = None
                continue
            spec = getattr(specs, name)
            parts[name].append([
                _on(_take(t, _cache_ranges(spec, t.shape, mesh, row, mi)),
                    devs[mi]).contiguous() for mi in range(mesh.tp)])
    return DecodeCache(*(None if parts[n] is None else ShardGrid(parts[n])
                         for n in ("k", "v", "ssm", "conv", "pos")))


def gather_cache(cache, cfg: ModelConfig, plan: ShardingPlan, mesh,
                 device=None):
    """``shard_cache``'s inverse: the logical ``DecodeCache`` on
    ``device`` (default the first coordinate's); replicated parts are
    taken from their first holder."""
    from repro_torch.models.model import DecodeCache
    specs = cache_pspecs(cfg, plan)
    out = {}
    for name in ("k", "v", "ssm", "conv", "pos"):
        grid = getattr(cache, name)
        if grid is None:
            out[name] = None
            continue
        spec = getattr(specs, name)
        t0 = grid.parts[0][0]
        shape = []
        for a, e in enumerate(spec):
            # an axis's logical extent: the sum of the distinct shards'
            sizes = {}
            for row in range(mesh.n_batch):
                for mi in range(mesh.tp):
                    idx = axis_index(e, mesh, row, mi)[0]
                    sizes[idx] = grid.parts[row][mi].shape[a]
            shape.append(sum(sizes.values()))
        t = torch.empty(shape, dtype=t0.dtype, device=device or t0.device)
        for row in reversed(range(mesh.n_batch)):
            for mi in reversed(range(mesh.tp)):
                _put(t, _cache_ranges(spec, shape, mesh, row, mi),
                     grid.parts[row][mi])
        out[name] = t
    return DecodeCache(**out)


def reshard_cache(cache, cfg: ModelConfig, src: ShardingPlan,
                  dst: ShardingPlan, mesh, max_len: int | None = None):
    """Move a cache from plan ``src``'s layout to plan ``dst``'s (the
    prefill plan's to the decode plan's: the ``device_put`` between the
    JAX package's two jitted programs), through the logical cache;
    ``max_len`` pads the sequence with zeros to that length (room for
    the decode steps)."""
    logical = gather_cache(cache, cfg, src, mesh)
    if max_len is not None and logical.k is not None:
        S = logical.k.shape[2]
        pad = [0, 0, 0, 0, 0, max_len - S]
        logical.k = torch.nn.functional.pad(logical.k, pad)
        logical.v = torch.nn.functional.pad(logical.v, pad)
    return shard_cache(logical, cfg, dst, mesh)
