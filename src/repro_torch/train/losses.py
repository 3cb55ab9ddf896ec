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
    denom = torch.clamp(valid.sum(), min=1.0)
    loss = (nll * valid).sum() / denom
    acc = ((logits.argmax(-1) == labels).float() * valid).sum() / denom
    return loss, {"nll": loss, "accuracy": acc, "tokens": denom}
