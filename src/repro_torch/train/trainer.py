"""Training step factory + loop: remat, grad accumulation, compression (the
JAX package's ``train/trainer.py``).

``make_train_step`` builds an eager step function (PyTorch has no ``jit``
to hand it to); ``Trainer`` is the host-side loop with checkpointing and
restart used by ``repro_torch.train_100m``.  On the card the attention
forward and backward run through the prefill kernel and its backward
kernel (``kernels.ops.flash_attention``), the SSD chunk through its
kernel and its backward kernel (``kernels.ops.ssd_chunk``).  Given the
JAX package's train plan and a mesh, the step, the state and the loop run
sharded (data-parallel groups, fsdp rows, the sequence-parallel residual:
``models.sharded``), and checkpoints hold the logical arrays.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import forward, init_params
from repro_torch.train.losses import cross_entropy, cross_entropy_sums
from repro_torch.train.optimizer import (AdamWConfig, adamw_update,
                                         adamw_update_sharded,
                                         compress_roundtrip, init_opt_state,
                                         tree_leaves, tree_map)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: AdamWConfig = AdamWConfig()
    remat: bool = True
    microbatches: int = 1           # gradient accumulation
    moe_aux_weight: float = 0.01
    grad_compression: bool = False  # int8 roundtrip of the DP all-reduce
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16


def cast_for_compute(params, dtype):
    """fp32 master params -> compute copies (leaves with ndim >= 2 only, as
    in the JAX package, which with layer-stacked blocks includes the
    stacked gains and the MoE router); the casts stay differentiable back
    to the fp32 master."""
    return tree_map(
        lambda p: p.to(dtype)
        if (p.ndim >= 2 and p.dtype == torch.float32) else p, params)


def loss_fn(params, cfg: ModelConfig, batch: dict, tcfg: TrainConfig):
    """(total loss, metrics) of one batch of device tensors: ``labels``
    [B, S] and ``tokens`` [B, S] or ``embeds`` [B, S, d]."""
    params = cast_for_compute(params, tcfg.compute_dtype)
    tokens = batch.get("tokens")
    embeds = batch.get("embeds")
    labels = batch["labels"]
    if cfg.is_moe:
        logits, aux = forward(params, cfg, tokens, embeds,
                              remat=tcfg.remat, with_aux=True)
    else:
        logits = forward(params, cfg, tokens, embeds, remat=tcfg.remat)
        aux = torch.zeros((), dtype=torch.float32, device=logits.device)
    loss, metrics = cross_entropy(logits, labels, cfg)
    total = loss + tcfg.moe_aux_weight * aux
    metrics["aux_loss"] = aux
    return total, metrics


def value_and_grad(params, cfg: ModelConfig, batch: dict,
                   tcfg: TrainConfig) -> tuple[torch.Tensor, dict, Any]:
    """(total loss, metrics, grads) of ``loss_fn``: grads have params'
    structure, fp32 for the fp32 master leaves (zeros where a leaf takes
    no part); the values are detached."""
    leaves = tree_leaves(params)
    live = [p.detach().requires_grad_(True) for p in leaves]
    it = iter(live)
    total, metrics = loss_fn(tree_map(lambda _: next(it), params), cfg,
                             batch, tcfg)
    grads = torch.autograd.grad(total, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    it = iter(grads)
    return (total.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_map(lambda _: next(it), params))


def sharded_value_and_grad(params: list, cfg: ModelConfig, batch: dict,
                           tcfg: TrainConfig, plan, mesh
                           ) -> tuple[torch.Tensor, dict, Any]:
    """``value_and_grad`` of a sharded state: ``params`` the [rows][tp]
    grid of coordinate trees of ``plan`` over ``mesh``, ``batch`` the
    logical batch.  Returns (total loss, metrics, the reduced logical
    gradients, fp32, each element once).

    The batch is cut over the data groups (``shard_batch``); each group
    reads its own aliases of the coordinates it needs (its own and its
    fsdp peers'), so its gradients come out apart, explicitly, and are
    summed onto the logical leaves in group order, then shard order (a
    reduce-scatter over data onto each coordinate's fsdp rows, an
    all-reduce for replicated leaves), never by autograd's accumulation
    into a shared leaf.  The loss is the whole batch's: each group's nll,
    correct predictions and valid tokens (``cross_entropy_sums``) are
    summed in group order and divided once, and the MoE load-balance
    loss is the whole batch's too (``models.sharded._balance``)."""
    from repro_torch.launch import sharding as shd
    from repro_torch.models import sharded

    pm = sharded.PlanModel.from_shards(params, cfg, plan, mesh)
    parts = shd.shard_batch(batch, plan, mesh)
    aliases, flat = [], []
    for g in range(pm.groups):
        need = set(pm.peers(g)) | {g}
        grid = [[None] * mesh.tp for _ in params]
        for row in sorted(need):
            for mi in range(mesh.tp):
                live = [(path, t.detach().requires_grad_(True)) for path, t
                        in shd.leaves_with_paths(params[row][mi])]
                flat += [t for _, t in live]
                grid[row][mi] = shd.tree_from_paths(live)
        aliases.append(grid)
    views = pm.views(aliases, dtype=tcfg.compute_dtype)
    tokens = [p["tokens"] for p in parts] if "tokens" in batch else None
    embeds = [p["embeds"] for p in parts] if "embeds" in batch else None
    logits, aux, _ = sharded.run_full(
        views, tokens, embeds, act_seq=plan.rules["act_seq"] is not None,
        remat=tcfg.remat, with_aux=cfg.is_moe)
    dev = logits[0].device
    sums = [cross_entropy_sums(lg, p["labels"].to(lg.device), cfg)
            for lg, p in zip(logits, parts)]
    nll, acc, count = (sharded._reduce([s[i] for s in sums], dev)
                       for i in range(3))
    denom = torch.clamp(count, min=1.0)
    loss = nll / denom
    if not cfg.is_moe:
        aux = torch.zeros((), dtype=torch.float32, device=dev)
    total = loss + tcfg.moe_aux_weight * aux
    metrics = {"nll": loss, "accuracy": acc / denom, "tokens": denom,
               "aux_loss": aux}
    grads = iter(torch.autograd.grad(total, flat, allow_unused=True))
    lay = shd.ParamLayout(cfg, plan, mesh)
    out = {path: torch.zeros(shape, dtype=torch.float32, device=dev)
           for path, shape in shd.leaves_with_paths(shd.param_shapes(cfg))}
    for grid in aliases:
        for row, parts in enumerate(grid):
            for mi, tree in enumerate(parts):
                if tree is not None:
                    lay.add(out, shd.tree_from_paths([
                        (path, next(grads)) for path, _
                        in shd.leaves_with_paths(tree)]), row, mi)
    return (total.detach(), {k: v.detach() for k, v in metrics.items()},
            shd.tree_from_paths(list(out.items())))


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig | None = None,
                    plan=None, mesh=None) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics).

    state = {"params": ..., "opt": ...} (updated in place); batch leaves
    are device tensors with leading [global_batch, seq].  With
    ``microbatches > 1`` the first microbatch's gradients and metrics are
    taken, the others added in order, and the sums divided by
    ``microbatches``, as the JAX package's ``lax.scan`` does.

    With a ``plan`` (``launch.sharding.make_plan(cfg, "train", ...)``)
    and its ``mesh`` the state is sharded (``init_train_state(...,
    plan=, mesh=)``, ``launch.sharding.shard_train_state``) and the batch
    stays logical: each microbatch (the same rows as unsharded) is cut
    over the data groups, its gradients reduced onto the logical leaves
    (``sharded_value_and_grad``), where the int8 roundtrip and the clip
    norm see each element once, and every coordinate's AdamW runs on its
    own rows (``adamw_update_sharded``).
    """
    tcfg = tcfg or TrainConfig()
    if plan is not None:
        from repro_torch.launch.sharding import ParamLayout
        part = ParamLayout(cfg, plan, mesh).part

    def single_grads(params, batch):
        if plan is None:
            _, metrics, grads = value_and_grad(params, cfg, batch, tcfg)
        else:
            _, metrics, grads = sharded_value_and_grad(
                params, cfg, batch, tcfg, plan, mesh)
        return grads, metrics

    def train_step(state, batch):
        params = state["params"]
        n = tcfg.microbatches
        if n > 1:
            split = {k: x.reshape((n, x.shape[0] // n) + tuple(x.shape[1:]))
                     for k, x in batch.items()}
            grads, metrics = single_grads(
                params, {k: x[0] for k, x in split.items()})
            for i in range(1, n):
                g, m = single_grads(params, {k: x[i] for k, x in split.items()})
                grads = tree_map(torch.add, grads, g)
                metrics = tree_map(torch.add, metrics, m)
            grads = tree_map(lambda g: g / n, grads)
            metrics = tree_map(lambda m: m / n, metrics)
        else:
            grads, metrics = single_grads(params, batch)
        if tcfg.grad_compression:
            grads = compress_roundtrip(grads)
        if plan is None:
            new_params, new_opt, opt_metrics = adamw_update(
                params, grads, state["opt"], tcfg.opt)
        else:
            new_params, new_opt, opt_metrics = adamw_update_sharded(
                params, grads, state["opt"], tcfg.opt, part)
        metrics.update(opt_metrics)
        return {"params": new_params, "opt": new_opt}, metrics

    return train_step


def init_train_state(cfg: ModelConfig, seed: int = 0,
                     tcfg: TrainConfig | None = None, device="cuda",
                     plan=None, mesh=None) -> dict:
    """fp32 params from ``seed`` and zero moments; with a ``plan`` and its
    ``mesh``, sharded (``launch.sharding.shard_train_state``: each
    coordinate its own copy of its cut; the logical params are made on
    ``device`` first and dropped)."""
    tcfg = tcfg or TrainConfig()
    params = init_params(cfg, seed, tcfg.param_dtype, device)
    if plan is None:
        return {"params": params, "opt": init_opt_state(params)}
    from repro_torch.launch.sharding import shard_params
    grid = shard_params(params, cfg, plan, mesh, copy=True)
    del params
    opt = [[init_opt_state(t) for t in row] for row in grid]
    return {"params": grid,
            "opt": {"m": [[o["m"] for o in row] for row in opt],
                    "v": [[o["v"] for o in row] for row in opt],
                    "step": opt[0][0]["step"]}}


def batch_to_device(batch: dict, device) -> dict:
    """The pipeline's numpy batch as tensors on ``device``."""
    return {k: torch.from_numpy(np.asarray(x)).to(device)
            for k, x in batch.items()}


class Trainer:
    """Host loop: data -> step -> metrics -> periodic checkpoint, with
    resume-from-latest restart (fault tolerance).  ``checkpoint_every`` 0
    saves only at the end of ``run``."""

    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig,
                 data_iter, checkpoint_dir: str | None = None,
                 checkpoint_every: int = 50, seed: int = 0, device="cuda",
                 plan=None, mesh=None):
        from repro_torch.train.checkpoint import CheckpointManager
        self.cfg = cfg
        self.tcfg = tcfg
        self.data_iter = data_iter
        self.device = torch.device(device)
        self.layout = None if plan is None else (cfg, plan, mesh)
        self.step_fn = make_train_step(cfg, tcfg, plan, mesh)
        self.ckpt = (CheckpointManager(checkpoint_dir)
                     if checkpoint_dir else None)
        self.checkpoint_every = checkpoint_every
        self.state = init_train_state(cfg, seed, tcfg, self.device, plan,
                                      mesh)
        self.step = 0
        if self.ckpt is not None:
            restored = self.ckpt.restore_latest(self.state, self.layout)
            if restored is not None:
                self.state, self.step = restored

    def run(self, steps: int, log_every: int = 10) -> list[dict]:
        history = []
        t0 = time.time()
        for _ in range(steps):
            batch = batch_to_device(next(self.data_iter), self.device)
            self.state, metrics = self.step_fn(self.state, batch)
            self.step += 1
            if self.step % log_every == 0 or self.step == 1:
                m = {k: float(v) for k, v in metrics.items()}
                m["step"] = self.step
                m["wall"] = time.time() - t0
                history.append(m)
            if (self.ckpt is not None and self.checkpoint_every
                    and self.step % self.checkpoint_every == 0):
                self.ckpt.save(self.state, self.step, layout=self.layout)
        if self.ckpt is not None:
            self.ckpt.save(self.state, self.step, layout=self.layout)
            self.ckpt.wait()
        return history
