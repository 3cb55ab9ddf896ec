"""Training step factory + loop: remat, grad accumulation, compression (the
JAX package's ``train/trainer.py``).

``make_train_step`` builds an eager step function (PyTorch has no ``jit``
to hand it to); ``Trainer`` is the host-side loop with checkpointing and
restart used by ``repro_torch.train_100m``.  On the card the attention
forward and backward run through the prefill kernel and its backward
kernel (``kernels.ops.flash_attention``); the SSD chunk kernel has no
backward yet, so models with SSM layers raise there (they train on the
CPU through the plain versions).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import forward, init_params
from repro_torch.train.losses import cross_entropy
from repro_torch.train.optimizer import (AdamWConfig, adamw_update,
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


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig | None = None
                    ) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics).

    state = {"params": ..., "opt": ...} (updated in place); batch leaves
    are device tensors with leading [global_batch, seq].  With
    ``microbatches > 1`` the first microbatch's gradients and metrics are
    taken, the others added in order, and the sums divided by
    ``microbatches``, as the JAX package's ``lax.scan`` does.
    """
    tcfg = tcfg or TrainConfig()

    def single_grads(params, batch):
        _, metrics, grads = value_and_grad(params, cfg, batch, tcfg)
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
        new_params, new_opt, opt_metrics = adamw_update(
            params, grads, state["opt"], tcfg.opt)
        metrics.update(opt_metrics)
        return {"params": new_params, "opt": new_opt}, metrics

    return train_step


def init_train_state(cfg: ModelConfig, seed: int = 0,
                     tcfg: TrainConfig | None = None, device="cuda") -> dict:
    tcfg = tcfg or TrainConfig()
    params = init_params(cfg, seed, tcfg.param_dtype, device)
    return {"params": params, "opt": init_opt_state(params)}


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
                 checkpoint_every: int = 50, seed: int = 0, device="cuda"):
        from repro_torch.train.checkpoint import CheckpointManager
        self.cfg = cfg
        self.tcfg = tcfg
        self.data_iter = data_iter
        self.device = torch.device(device)
        self.step_fn = make_train_step(cfg, tcfg)
        self.ckpt = (CheckpointManager(checkpoint_dir)
                     if checkpoint_dir else None)
        self.checkpoint_every = checkpoint_every
        self.state = init_train_state(cfg, seed, tcfg, self.device)
        self.step = 0
        if self.ckpt is not None:
            restored = self.ckpt.restore_latest(self.state)
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
                self.ckpt.save(self.state, self.step)
        if self.ckpt is not None:
            self.ckpt.save(self.state, self.step)
            self.ckpt.wait()
        return history
