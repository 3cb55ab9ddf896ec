"""Training loss: masked cross-entropy over the padded vocabulary (the JAX
package's ``train/losses.py``)."""
from __future__ import annotations

import torch

from repro_torch.models.config import ModelConfig


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  cfg: ModelConfig, mask: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, dict]:
    """logits [B, S, Vpad] fp32, labels [B, S] int (-1 = ignore).

    Padded vocab ids are excluded from the partition function (their
    logits are set to -1e30).  Returns (loss, {"nll", "accuracy",
    "tokens"}), each a 0-d fp32 tensor.
    """
    nll_sum, acc_sum, count = cross_entropy_sums(logits, labels, cfg, mask)
    denom = torch.clamp(count, min=1.0)
    loss = nll_sum / denom
    acc = acc_sum / denom
    return loss, {"nll": loss, "accuracy": acc, "tokens": denom}


def cross_entropy_sums(logits: torch.Tensor, labels: torch.Tensor,
                       cfg: ModelConfig, mask: torch.Tensor | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``cross_entropy``'s sums over the valid tokens: (nll, correct
    predictions, valid tokens), 0-d fp32 each.  A batch split over data
    shards sums each in shard order and divides once."""
    Vpad = logits.shape[-1]
    vmask = torch.arange(Vpad, device=logits.device) < cfg.vocab_size
    logits = torch.where(vmask[None, None, :], logits,
                         torch.full_like(logits, -1e30))
    logz = torch.logsumexp(logits, dim=-1)
    labels = labels.long()
    gold = torch.gather(logits, -1, labels.clamp(min=0)[..., None])[..., 0]
    nll = logz - gold
    valid = labels >= 0
    if mask is not None:
        valid = valid & (mask > 0)
    valid = valid.float()
    return ((nll * valid).sum(),
            ((logits.argmax(-1) == labels).float() * valid).sum(),
            valid.sum())
