# Frozen copy of taste_spokenlm_tpu_torch/ops/sampling.py at commit 1a9abc6: the plain path
# that the benchmark holds the port against.  Kernel, remat and
# data-parallel routes resolve to portbench/reference/stubs.py.
"""Categorical sampling with temperature, top-k / top-p (nucleus), a
repetition penalty, a banned-token mask and min-length EOS masking
(counterpart of the JAX ops/sampling.py).

A categorical draw is argmax(logits + gumbel noise), as in
`jax.random.categorical`.  The noise comes from a `torch.Generator`, or is
passed in (`gumbel`) so that a test can hand both frameworks the same
numbers.  `mask_top_p` copies the JAX package's sort-free threshold search
(`_refine_bracket`) step for step: a sort-based nucleus keeps another set
where two logits meet the boundary.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

NEG_INF = float(np.float32(np.finfo(np.float32).min / 2))


def temperature_scale(logits: torch.Tensor, temperature) -> torch.Tensor:
    t = torch.as_tensor(temperature, dtype=logits.dtype, device=logits.device)
    return logits / torch.clamp(t, min=1e-6)


def apply_repetition_penalty(logits: torch.Tensor, token_counts: torch.Tensor,
                             penalty: float) -> torch.Tensor:
    """CTRL-style penalty on tokens already emitted (token_counts > 0):
    positive logits divided by `penalty`, negative ones multiplied."""
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(token_counts > 0, penalized, logits)


def _refine_bracket(f, weights, lo, hi, budget, fan: int, rounds: int,
                    strict: bool = False):
    """The JAX package's wide-fan threshold search: the bracket (lo, hi) of
    the monotone predicate sum_v weights[v] * (f[v] >= tau) >= budget
    (> budget when `strict`), narrowed `rounds` times by a factor fan + 1."""
    grid = torch.arange(1, fan + 1, dtype=torch.float32, device=f.device) / (fan + 1)
    for _ in range(rounds):
        taus = lo + (hi - lo) * grid                        # [..., fan]
        kept = f[..., :, None] >= taus[..., None, :]        # [..., V, fan]
        if weights is None:
            stat = kept.float().sum(dim=-2)
        else:
            stat = torch.where(kept, weights[..., :, None],
                               weights.new_zeros(())).sum(dim=-2)
        ok = stat > budget if strict else stat >= budget
        idx = ok.int().sum(dim=-1, keepdim=True) - 1         # True prefix
        lo_new = torch.where(idx >= 0, torch.gather(taus, -1, idx.clamp(min=0)),
                             lo)
        hi_new = torch.where(idx + 1 < fan, torch.gather(
            taus, -1, (idx + 1).clamp(max=fan - 1)), hi)
        lo, hi = lo_new, hi_new
    return lo, hi


def mask_top_p(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus filtering with the reference's semantics: keep the largest
    set of top tokens whose probability mass is <= p, and always the top-1
    token; the rest become NEG_INF.  The threshold comes from 14 rounds of
    the fan-8 search over the finite logit range, as in JAX."""
    f = logits.float()
    probs = torch.softmax(f, dim=-1)
    mx = f.amax(dim=-1, keepdim=True)
    lo = torch.where(f > NEG_INF * 0.5, f, mx).amin(dim=-1, keepdim=True)
    _, hi = _refine_bracket(f, probs, lo, mx, torch.tensor(
        p, dtype=torch.float32, device=f.device), fan=8, rounds=14, strict=True)
    keep = (f >= hi) | (f >= mx)
    return torch.where(keep, logits, logits.new_tensor(NEG_INF))


def mask_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Keep the logits >= the k-th largest, set the rest to NEG_INF.

    The JAX version finds the k-th largest value with a threshold search
    instead of a sort; the kept set is the same unless two logits tie at the
    boundary, where both versions keep every tied entry."""
    f = logits.float()
    kth = torch.topk(f, k, dim=-1).values[..., -1:]
    return torch.where(f >= kth, logits, logits.new_tensor(NEG_INF))


def gumbel_noise(shape, generator: Union[None, torch.Generator,
                                          Sequence[torch.Generator]] = None,
                 device=None) -> torch.Tensor:
    """Standard Gumbel noise -log(-log(U)), U in the open interval (0, 1).

    `generator` may be a sequence of shape[0] generators: row i of the
    noise then comes from generator i alone (its uniforms are what
    torch.rand(shape[1:], generator=generator[i]) would draw), so a row's
    draws do not depend on the other rows."""
    if isinstance(generator, (list, tuple)):
        if len(generator) != shape[0]:
            raise ValueError(f"{len(generator)} generators for {shape[0]} rows")
        u = torch.empty(shape, device=device)
        for row, gen in zip(u, generator):
            row.uniform_(generator=gen)
    else:
        u = torch.rand(shape, generator=generator, device=device)
    tiny = float(np.finfo(np.float32).tiny)
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
