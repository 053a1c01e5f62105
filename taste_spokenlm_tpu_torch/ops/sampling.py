"""Categorical sampling with temperature, top-k, a banned-token mask and
min-length EOS masking (counterpart of the JAX ops/sampling.py `sample`).

A categorical draw is argmax(logits + gumbel noise), as in
`jax.random.categorical`.  The noise comes from a `torch.Generator`, or is
passed in (`gumbel`) so that a test can hand both frameworks the same
numbers.  Top-p and the repetition penalty belong to the completion slice.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

NEG_INF = float(np.float32(np.finfo(np.float32).min / 2))


def mask_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Keep the logits >= the k-th largest, set the rest to NEG_INF.

    The JAX version finds the k-th largest value with a threshold search
    instead of a sort; the kept set is the same unless two logits tie at the
    boundary, where both versions keep every tied entry."""
    f = logits.float()
    kth = torch.topk(f, k, dim=-1).values[..., -1:]
    return torch.where(f >= kth, logits, logits.new_tensor(NEG_INF))


def gumbel_noise(shape, generator: Optional[torch.Generator] = None,
                 device=None) -> torch.Tensor:
    """Standard Gumbel noise -log(-log(U)), U in the open interval (0, 1)."""
    tiny = float(np.finfo(np.float32).tiny)
    u = torch.rand(shape, generator=generator, device=device)
    u = torch.clamp(u, min=tiny, max=1.0 - 2 ** -24)
    return -torch.log(-torch.log(u))


def sample(logits: torch.Tensor, temperature: float = 1.0,
           top_k: Optional[int] = None,
           banned: Optional[torch.Tensor] = None,
           forbid_eos: Optional[torch.Tensor] = None,
           eos_id: Optional[int] = None,
           generator: Optional[torch.Generator] = None,
           gumbel: Optional[torch.Tensor] = None) -> torch.Tensor:
    """logits [..., V] -> sampled ids [...] (int64).

    `banned`: bool [V] or [..., V].  `forbid_eos`: bool [...]; where True the
    `eos_id` logit is masked.  `gumbel` [..., V] overrides the noise."""
    logits = logits.float() / max(float(temperature), 1e-6)
    neg = logits.new_tensor(NEG_INF)
    if banned is not None:
        logits = torch.where(banned, neg, logits)
    if forbid_eos is not None and eos_id is not None:
        is_eos = torch.arange(logits.shape[-1], device=logits.device) == eos_id
        logits = torch.where(is_eos & forbid_eos[..., None], neg, logits)
    if top_k is not None and top_k > 0:
        logits = mask_top_k(logits, top_k)
    if gumbel is None:
        gumbel = gumbel_noise(logits.shape, generator, logits.device)
    return torch.argmax(logits + gumbel.to(logits.device), dim=-1)
