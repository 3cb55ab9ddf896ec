"""AdamW + gradient clipping + int8 gradient compression (the JAX package's
``train/optimizer.py``), on nested dicts of tensors.

The order of operations is JAX's, so the two agree to fp32 rounding: the
schedule ``lr_at`` and the bias corrections ``b ** t`` in fp32, weight
decay only on leaves with ``ndim >= 2`` (the layer-stacked blocks make
that every matrix and every stacked gain), the clip scale
``min(1, max / (norm + 1e-9))``, round-half-even in the int8 roundtrip.
Trees are walked in sorted key order, as ``jax.tree`` walks dicts.

``adamw_update`` writes the new parameters and moments into the given
tensors in place (their temporaries are one leaf at a time), where JAX
returns new arrays: whoever keeps a parameter for later (a checkpoint)
copies it first.

``psum_compressed`` is the int8-compressed data-parallel all-reduce: each
rank quantizes its gradients, ``torch.distributed`` sums the int8
payloads as int32 and the scales over a process group, and every rank
dequantizes the average, as JAX's ``psum_compressed`` does under
``shard_map``.  ``compress_roundtrip`` gives the numerics of one rank.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


# --------------------------------------------------------------------------
# Nested dicts of tensors.
# --------------------------------------------------------------------------


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (and the same leaves of ``rest``),
    keeping the dict structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    """The leaves in sorted key order (``jax.tree.leaves``'s order)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


# --------------------------------------------------------------------------
# AdamW.
# --------------------------------------------------------------------------


def lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup then cosine decay to ``min_lr_ratio``; fp32 0-d."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def init_opt_state(params: Any) -> dict:
    def zeros(p):
        return tree_map(lambda x: torch.zeros_like(x, dtype=torch.float32), p)
    device = tree_leaves(params)[0].device
    return {"m": zeros(params), "v": zeros(params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree_leaves(tree)))


def clip_by_global_norm(grads: Any, max_norm: float
                        ) -> tuple[Any, torch.Tensor]:
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: g * scale, grads), norm


def _clipped(grads: Any, cfg: AdamWConfig) -> tuple[Any, torch.Tensor]:
    grads = tree_map(lambda g: g.to(torch.float32), grads)
    if cfg.grad_clip > 0:
        return clip_by_global_norm(grads, cfg.grad_clip)
    return grads, global_norm(grads)


def _updater(step: torch.Tensor, cfg: AdamWConfig) -> tuple[Callable,
                                                              torch.Tensor]:
    """(upd(p, m, v, g), lr) of optimizer step ``step``: ``upd`` writes one
    leaf's new parameter and moments in place."""
    lr = lr_at(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    t = step.to(torch.float32)
    b1_t = torch.tensor(b1, dtype=torch.float32, device=t.device)
    b2_t = torch.tensor(b2, dtype=torch.float32, device=t.device)
    bc1 = 1 - b1_t ** t
    bc2 = 1 - b2_t ** t

    def upd(p, m, v, g):
        m.copy_(b1 * m + (1 - b1) * g)
        v.copy_(b2 * v + (1 - b2) * g * g)
        mhat = m / _on(bc1, m.device)
        vhat = v / _on(bc2, v.device)
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        if cfg.weight_decay > 0 and p.ndim >= 2:   # decay matrices only
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        p.copy_((p.to(torch.float32) - _on(lr, p.device) * delta)
                .to(p.dtype))
    return upd, lr


def _on(t: torch.Tensor, device) -> torch.Tensor:
    return t if t.device == device else t.to(device)


def adamw_update(params: Any, grads: Any, state: dict, cfg: AdamWConfig
                 ) -> tuple[Any, dict, dict]:
    """Returns (params, state, metrics); params, m and v are updated in
    place and returned, the step counter is a new tensor."""
    grads, gnorm = _clipped(grads, cfg)
    step = state["step"] + 1
    upd, lr = _updater(step, cfg)
    tree_map(upd, params, state["m"], state["v"], grads)
    return params, {"m": state["m"], "v": state["v"], "step": step}, \
        {"grad_norm": gnorm, "lr": lr}


def adamw_update_sharded(params: list, grads: Any, state: dict,
                         cfg: AdamWConfig, part: Callable
                         ) -> tuple[list, dict, dict]:
    """``adamw_update`` over a sharded state: ``params``, ``state["m"]``
    and ``state["v"]`` are [rows][tp] grids of coordinate trees (the
    plan's cut, ``launch.sharding.shard_train_state``); ``grads`` is the
    reduced logical gradient tree, each element once, so its global norm
    counts every logical element once however many coordinates hold it;
    ``part(tree, row, mi)`` cuts a logical tree to a coordinate.  Each
    coordinate updates its own rows and its own m/v rows in place (the
    update is elementwise: replicated leaves stay equal)."""
    grads, gnorm = _clipped(grads, cfg)
    step = state["step"] + 1
    upd, lr = _updater(step, cfg)
    for row, (ps, ms, vs) in enumerate(zip(params, state["m"], state["v"])):
        for mi, (p, m, v) in enumerate(zip(ps, ms, vs)):
            tree_map(upd, p, m, v, part(grads, row, mi))
    return params, {"m": state["m"], "v": state["v"], "step": step}, \
        {"grad_norm": gnorm, "lr": lr}


# --------------------------------------------------------------------------
# int8 gradient compression (the numerics of the DP all-reduce's payload).
# --------------------------------------------------------------------------


def quantize_int8(x: torch.Tensor, block: int = 256
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Blockwise symmetric int8 quantization along the flattened tensor."""
    flat = x.reshape(-1)
    pad = (-flat.numel()) % block
    flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(-1, block)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, shape, size: int
                    ) -> torch.Tensor:
    flat = (q.to(torch.float32) * scale).reshape(-1)[:size]
    return flat.reshape(shape)


def compress_roundtrip(grads: Any) -> Any:
    """Quantize -> dequantize every gradient leaf (the numerics of an int8
    compressed all-reduce)."""
    def roundtrip(g):
        q, s = quantize_int8(g)
        return dequantize_int8(q, s, g.shape, g.numel()).to(g.dtype)
    return tree_map(roundtrip, grads)


def psum_compressed(grads: Any, group=None) -> Any:
    """int8-compressed all-reduce over ``group`` (default: the world):
    quantize locally, sum the int8 payloads as int32 and the scales, then
    dequantize with the mean scale and average.  Bytes on the wire: 1/4 of
    fp32.  Every rank of the group must call it with the same tree."""
    import torch.distributed as dist

    n = dist.get_world_size(group)

    def reduce_leaf(g):
        q, s = quantize_int8(g)
        qsum = q.to(torch.int32)
        dist.all_reduce(qsum, group=group)     # int32 accumulation
        ssum = s.clone()
        dist.all_reduce(ssum, group=group)     # scales add
        flat = (qsum.to(torch.float32) * (ssum / n)).reshape(-1)[:g.numel()]
        return (flat.reshape(g.shape) / n).to(g.dtype)
    return tree_map(reduce_leaf, grads)
