"""Loss and metric ops of the stage-1 step (counterpart of the JAX
ops/losses.py `IGNORE_ID`, `label_smoothing_ce` and `masked_accuracy`).

`chunked_ce_kl` and the KL to a frozen reference belong to the stage-2 step
and are not ported yet.
"""

from __future__ import annotations

import math

import torch

IGNORE_ID = -1


def label_smoothing_ce(logits: torch.Tensor, targets: torch.Tensor,
                       smoothing: float = 0.0, normalize_length: bool = True,
                       ignore_id: int = IGNORE_ID) -> torch.Tensor:
    """KL(smoothed one-hot || softmax(logits)) summed over the valid
    positions, over the token count (normalize_length) or the batch size.
    logits [B, T, V]; targets [B, T] with `ignore_id` masked.  The closed
    form of JAX: the constant entropy of the smoothed one-hot, minus
    (conf - low) log q_target and low * sum log q, on an f32 log-softmax."""
    v = logits.shape[-1]
    valid = targets != ignore_id
    tgt = torch.where(valid, targets, torch.zeros_like(targets)).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    confidence = 1.0 - smoothing
    low = smoothing / (v - 1) if v > 1 else 0.0
    entropy = 0.0
    if low > 0.0:
        entropy += (v - 1) * low * math.log(low)
    if confidence > 0.0:
        entropy += confidence * math.log(confidence)
    logp_tgt = torch.gather(logp, -1, tgt[..., None])[..., 0]
    cross = (confidence - low) * logp_tgt
    if low > 0.0:
        cross = cross + low * logp.sum(dim=-1)
    kl = torch.where(valid, entropy - cross, torch.zeros_like(cross))
    denom = (torch.clamp(valid.sum(), min=1) if normalize_length
             else logits.shape[0])
    return kl.sum() / denom


def masked_accuracy(logits: torch.Tensor, targets: torch.Tensor,
                    ignore_id: int = IGNORE_ID) -> torch.Tensor:
    """Top-1 accuracy over the non-ignored targets."""
    valid = targets != ignore_id
    correct = ((logits.argmax(dim=-1) == targets) & valid).sum()
    return correct.float() / torch.clamp(valid.sum(), min=1).float()
