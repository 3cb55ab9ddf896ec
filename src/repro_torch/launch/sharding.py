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


def shard_params(params, cfg: ModelConfig, plan: ShardingPlan, mesh):
    """Each (pipe, model) coordinate's parameter dict, on its device:
    ``grid[pi][mi]``.  ``cfg`` is the plan's run config (head-padded in
    "pad" mode, with ``params`` padded to it by ``pad_attention_params``).

    A leaf is cut along every axis its spec puts over a mesh axis: the
    layer axis over ``pipe`` by ``layer_layout`` (stage 0 keeps every layer
    where ``layers`` is unsharded), ``d_ff``/``vocab`` over ``model`` by
    ``split_ranges`` (``torch.tensor_split``'s ranges: an indivisible axis
    gets uneven shards, never padding; the MoE leaves' expert axis in "ep"
    mode, each expert's ff axis in "tp" mode), the attention leaves by
    ``attn_layout`` and the SSM leaves by ``ssm_layout`` (whole heads:
    columns [h0 * P, h1 * P) of the d_inner-wide leaves, rows of
    ``out_proj``, entries of the per-head ones); replicated leaves (the
    router, the SSM's B/C projections and conv weights) are whole.  On the
    device the params live on, every slice is a view (a layer range, a
    block of rows, or a strided block of columns that ``@`` accepts):
    co-located shards hold no weight copy; only ``conv_b``, one leaf over
    xs and B/C channels, becomes a small copy of the shard's xs columns
    and the whole B/C tail.  On another device a slice is copied there.
    """
    specs = param_pspecs(cfg, plan)
    pp, tp = mesh.pp, mesh.tp
    layers = layer_layout(cfg.n_layers, plan.rules, pp)
    heads = attn_layout(cfg, plan.rules, tp)
    ssm_heads = ssm_layout(cfg, plan.rules, tp)
    D = cfg.head_dim

    def cut(t, spec, pi, mi, head_cols=None, width=D):
        dev = mesh.device(pi, mi)
        for axis, entry in enumerate(spec):
            if entry == "pipe":
                t = _slice(t, axis, *layers[pi])
            elif entry == "model" and head_cols is None:
                t = _slice(t, axis, *split_ranges(t.shape[axis], tp)[mi])
        if head_cols is not None:
            axis, lo, hi = head_cols
            t = _slice(t, axis, lo * width, hi * width)
        return _on(t, dev)

    def attn_leaf(name, t, spec, pi, mi):
        q0, q1, kv0, kv1 = heads[mi]
        if name in ("wq", "bq"):
            return cut(t, spec, pi, mi, (t.ndim - 1, q0, q1))
        if name == "wo":
            return cut(t, spec, pi, mi, (1, q0, q1))
        if name in ("wk", "wv", "bk", "bv"):
            return cut(t, spec, pi, mi, (t.ndim - 1, kv0, kv1))
        return cut(t, spec, pi, mi)

    def ssm_leaf(name, t, spec, pi, mi):
        h0, h1 = ssm_heads[mi]
        P = cfg.ssm_head_dim
        if name in ("w_z", "w_x", "w_dt", "conv_x", "dt_bias", "A_log",
                    "D", "norm_w"):
            # the last axis: d_inner columns, or one entry a head
            width = 1 if name in ("w_dt", "dt_bias", "A_log", "D") else P
            return cut(t, spec, pi, mi, (t.ndim - 1, h0, h1), width)
        if name == "out_proj":
            return cut(t, spec, pi, mi, (1, h0, h1), P)
        if name == "conv_b":
            # one leaf over [xs | B | C] channels, unsharded by its spec:
            # the shard's xs columns and the whole B/C tail
            t = cut(t, spec, pi, mi)
            return torch.cat([t[:, h0 * P:h1 * P], t[:, cfg.d_inner:]],
                             dim=1)
        return cut(t, spec, pi, mi)

    def walk(tree, spec, pi, mi, leaf=None):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, spec[k], pi, mi, {
                    "attn": attn_leaf, "ssm": ssm_leaf}.get(k, leaf))
            elif leaf is not None:
                out[k] = leaf(k, v, spec[k], pi, mi)
            else:
                out[k] = cut(v, spec[k], pi, mi)
        return out

    return [[walk(params, specs, pi, mi) for mi in range(tp)]
            for pi in range(pp)]

