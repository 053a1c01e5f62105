"""Multi-head attention with an fp32 softmax (counterpart of the JAX
ops/attention.py `multi_head_attention`)."""

from __future__ import annotations

from typing import Optional

import torch

NEG_F32 = torch.finfo(torch.float32).min / 2


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         bias: Optional[torch.Tensor] = None,
                         mask: Optional[torch.Tensor] = None,
                         scale: Optional[float] = None) -> torch.Tensor:
    """q [B, Tq, H, D], k/v [B, Tk, H, D] -> [B, Tq, H, D].

    Logits and softmax in fp32 whatever the input dtype; the probabilities
    are cast back to the input dtype before the value product, as in JAX.
    `mask` is bool, broadcastable to [B, H, Tq, Tk]."""
    dtype = q.dtype
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias.float()
    if mask is not None:
        logits = torch.where(mask, logits, logits.new_tensor(NEG_F32))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(dtype).float(), v.float())
    return out.to(dtype)
