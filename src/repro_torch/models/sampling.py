"""Token sampling (greedy / temperature) with padded-vocab masking.

Greedy decoding matches the JAX package token for token: both mask the
padded vocab tail and take the first maximum.

The decode loop samples with a counter-based generator (``sample_step``):
Gumbel-max at ``temperature``, the noise of (seed, global decode step,
batch row, vocab id) an integer hash computed on the device from a device
step tensor.  A stream therefore depends only on (seed, step, row), as the
JAX package's ``fold_in`` keys do: it is the same for every decode horizon
and in the eager and the graphed engine, and one captured CUDA graph
serves every step.  It is not the JAX package's stream (``fold_in`` over
threefry cannot be reproduced here).  ``sample`` with a
``torch.Generator`` stays for the host's draws outside the loop (a
prefill's first token, the dense mode's step).
"""
from __future__ import annotations

import torch

from repro_torch.models.config import ModelConfig

_MASK32 = 0xFFFFFFFF


def mask_padded_vocab(logits: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Disallow the padded vocab tail (ids >= cfg.vocab_size)."""
    V = logits.shape[-1]
    if V == cfg.vocab_size:
        return logits
    idx = torch.arange(V, device=logits.device)
    return torch.where(idx[None, :] < cfg.vocab_size, logits,
                       torch.full_like(logits, float("-inf")))


def sample(logits: torch.Tensor, cfg: ModelConfig,
           generator: torch.Generator | None = None,
           temperature: float = 0.0) -> torch.Tensor:
    """logits: [B, Vpad] -> token ids [B] int32."""
    logits = mask_padded_vocab(logits, cfg)
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits.float() / temperature
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 of int64 ``x`` in [0, 2^32): the constant goes in
    16-bit halves, so no intermediate reaches 2^49 and the CPU and CUDA
    give the same bits (no int64 wrap)."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    """MurmurHash3's 32-bit finaliser on int64 holding values < 2^32."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def step_hash(seed: int, step: torch.Tensor, B: int, V: int
              ) -> torch.Tensor:
    """int64 [B, V] of 32-bit hashes of (``seed``, global decode step
    ``step``, row, vocab id), on ``step``'s device; every intermediate
    below 2^49."""
    dev = step.device
    s = _fmix32(torch.full((), ((seed >> 32) & _MASK32) ^ 0x9E3779B9,
                           dtype=torch.int64, device=dev))
    s = _fmix32(s ^ (seed & _MASK32))
    key = _fmix32(s ^ _fmix32(step.to(torch.int64) & _MASK32))
    rows = torch.arange(B, dtype=torch.int64, device=dev)
    row_key = _fmix32(key ^ _mul32(rows + 1, 0x9E3779B9))[:, None]
    ids = torch.arange(V, dtype=torch.int64, device=dev)[None, :]
    h = _fmix32(row_key ^ _mul32(ids + 1, 0x7FEB352D))
    return _fmix32(h ^ row_key)


def step_noise(seed: int, step: torch.Tensor, B: int, V: int
               ) -> torch.Tensor:
    """Gumbel noise [B, V] fp32 of (``seed``, global decode step ``step``,
    row, vocab id), on ``step``'s device: 23 bits of ``step_hash`` make a
    uniform u in (0, 1), exact in fp32, and -log(-log(u))."""
    h = step_hash(seed, step, B, V)
    u = ((h >> 9) * 2 + 1).to(torch.float32) * 2.0 ** -24
    return -torch.log(-torch.log(u))


def sample_step(logits: torch.Tensor, cfg: ModelConfig, seed: int,
                step: int | torch.Tensor, temperature: float = 1.0
                ) -> torch.Tensor:
    """logits [B, Vpad] -> token ids [B] int32 drawn from softmax(logits /
    temperature) by Gumbel-max with ``step_noise(seed, step)``; ``step``
    an int or an int64 device scalar (the decode graph's buffer), read
    only on the device.  ``temperature <= 0`` is greedy."""
    if temperature <= 0.0:
        return sample(logits, cfg)
    if not isinstance(step, torch.Tensor):
        step = torch.tensor(step, dtype=torch.int64, device=logits.device)
    B, V = logits.shape
    scores = (mask_padded_vocab(logits, cfg).float() / temperature
              + step_noise(seed, step, B, V))
    return torch.argmax(scores, dim=-1).to(torch.int32)
