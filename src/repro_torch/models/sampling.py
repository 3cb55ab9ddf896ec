"""Token sampling (greedy / temperature) with padded-vocab masking.

Greedy decoding matches the JAX package token for token: both mask the
padded vocab tail and take the first maximum.  The sampled path draws from
a ``torch.Generator`` seeded per global decode step (``step_generator``), so
a sampled stream is the same for every decode horizon; it is not the JAX
package's stream, whose ``fold_in`` keys torch cannot reproduce.
"""
from __future__ import annotations

import torch

from repro_torch.models.config import ModelConfig


def mask_padded_vocab(logits: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Disallow the padded vocab tail (ids >= cfg.vocab_size)."""
    V = logits.shape[-1]
    if V == cfg.vocab_size:
        return logits
    idx = torch.arange(V, device=logits.device)
    return torch.where(idx[None, :] < cfg.vocab_size, logits,
                       torch.full_like(logits, float("-inf")))


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator for global decode step ``step`` of a stream seeded
    with ``seed``: the per-step and horizon paths draw identical numbers."""
    g = torch.Generator(device=device)
    g.manual_seed((seed * 1_000_003 + step) % (2 ** 63))
    return g


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
