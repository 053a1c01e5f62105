"""Optimizer, learning-rate schedules and freeze masks (counterpart of the
JAX train/optim.py).

The schedules are functions of the step count, as optax's: the first update
uses schedule(0).  `trainable_mask` freezes by regex over the port's
parameter names (the reference state-dict names); `STAGE1_PHASES` holds
the stage-1 curriculum presets and `lora_only_mask` the stage-2 default,
each selecting the same parameters as the JAX package's flax-path
patterns (scripts/train.py, train/optim.py).  `make_optimizer` gives
optax's chain of `clip_by_global_norm` and Adam / AdamW over the trainable
parameters: gradients are left alone when their global norm is below the
limit and scaled by limit / norm otherwise (torch's clip_grad_norm_ uses
limit / (norm + 1e-6)).  Each parameter is updated in place in its own
dtype, with its moments in that dtype, one rounding per operation and the
constants rounded to that dtype first, as optax's jitted update of a bf16
tree (bench.py's train_main) does.
"""

from __future__ import annotations

import math
import re
from typing import Callable, Dict, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn as nn

Schedule = Callable[[int], float]

# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------


def warmup_lr(lr: float, warmup_steps: int) -> Schedule:
    """ESPnet WarmupLR: lr * w^0.5 * min(step^-0.5, step * w^-1.5)."""
    def schedule(step: int) -> float:
        s = float(max(step, 1))
        return lr * warmup_steps ** 0.5 * min(s ** -0.5,
                                              s * warmup_steps ** -1.5)
    return schedule


def _linear(init: float, end: float, steps: int) -> Schedule:
    """optax.linear_schedule (held at `init` when steps <= 0)."""
    def schedule(step: int) -> float:
        if steps <= 0:
            return init
        frac = 1.0 - min(max(step, 0), steps) / steps
        return (init - end) * frac + end
    return schedule


def constant_warmup_lr(lr: float, warmup_steps: int) -> Schedule:
    return _linear(0.0, lr, warmup_steps)


def cosine_lr(lr: float, warmup_steps: int, total_steps: int,
              min_lr: float = 0.0) -> Schedule:
    """Linear warmup + cosine decay (optax.warmup_cosine_decay_schedule)."""
    decay_steps = max(total_steps, warmup_steps + 1) - warmup_steps
    alpha = 0.0 if lr == 0.0 else min_lr / lr
    warm = _linear(0.0, lr, warmup_steps)

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return warm(step)
        count = min(float(step - warmup_steps), float(decay_steps))
        cosine = 0.5 * (1 + math.cos(math.pi * count / decay_steps))
        return lr * ((1 - alpha) * cosine + alpha)
    return schedule


def square_annealing_lr(lr: float, warmup_steps: int, total_steps: int,
                        min_lr: float = 1e-5) -> Schedule:
    """Linear warmup, then lr * ((max - step) / (max - warmup))^2."""
    def schedule(step: int) -> float:
        s = float(step)
        if s < warmup_steps:
            return lr * min(s / max(warmup_steps, 1), 1.0)
        frac = min(max((total_steps - s) / max(total_steps - warmup_steps, 1),
                       0.0), 1.0)
        return max(lr * frac ** 2, min_lr)
    return schedule


def noam_hold_lr(lr: float, warmup_steps: int, hold_steps: int = 0,
                 decay_rate: float = 0.5, min_lr: float = 0.0) -> Schedule:
    """NoamHoldAnnealing: linear warmup, a hold at the peak, then
    lr * warmup^d / (step - hold)^d."""
    def schedule(step: int) -> float:
        s = float(max(step, 1))
        if s < warmup_steps + hold_steps:
            return lr * min(s / max(warmup_steps, 1), 1.0)
        decay_steps = max(s - hold_steps, 1.0)
        return max(lr * max(1.0, warmup_steps ** decay_rate)
                   / decay_steps ** decay_rate, min_lr)
    return schedule


SCHEDULES = {
    "warmuplr": warmup_lr,
    "constantlr": lambda lr, warmup: constant_warmup_lr(lr, warmup),
    "cosine": cosine_lr,
    "square_annealing": square_annealing_lr,
    "noam_hold": noam_hold_lr,
}

# ---------------------------------------------------------------------------
# freeze / unfreeze by regex
# ---------------------------------------------------------------------------

_SEGMENTER = r"^audio_tower\.audio_joint_encoder_segmenter\.audio_segmenter\."
# scripts/train.py's stage-1 phases: text_only trains the speech decoder;
# no_vq adds the tower's decoder (JAX "audio_tower/decoder"); rvq adds the
# RVQ's projections ("audio_tower/vq").  The whisper encoder stays frozen.
STAGE1_PHASES = {
    "text_only": (r"^speech_decoder\.",),
    "no_vq": (_SEGMENTER + r"decoder\.", r"^speech_decoder\."),
    "rvq": (_SEGMENTER + r"decoder\.", r"^audio_tower\.vq\.",
            r"^speech_decoder\."),
}


def trainable_mask(model: nn.Module, unfreeze_patterns: Sequence[str]
                   ) -> Dict[str, bool]:
    """{parameter name: trainable}: the names that match a pattern train."""
    return {name: any(re.search(p, name) for p in unfreeze_patterns)
            for name, _ in model.named_parameters()}


# the stage-2 default: the LoRA adapters, both bridges and the pad embeds
# train; the base Llama (its tied embedding / head too) stays frozen
LORA_ONLY = (r"lora_A$", r"lora_B$", r"fuse_for_bridge_in_llm",
             r"extract_for_bridge_out_llm", r"pad_text_unit_embed",
             r"pad_audio_unit_embed")


def lora_only_mask(model: nn.Module) -> Dict[str, bool]:
    """The stage-2 mask (JAX's lora_only_mask)."""
    return trainable_mask(model, LORA_ONLY)


def apply_mask(model: nn.Module, mask: Dict[str, bool]) -> None:
    """requires_grad_ per the mask (frozen parameters get no gradient)."""
    for name, p in model.named_parameters():
        p.requires_grad_(bool(mask[name]))

# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """optax.global_norm: sqrt of the sum over tensors, in order, of each
    one's sum of squares in its own dtype (a bf16 tree gives a bf16
    norm)."""
    return torch.sqrt(sum((t * t).sum() for t in tensors))


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float,
                        norm: Optional[torch.Tensor] = None):
    """optax.clip_by_global_norm: each g unchanged when the global norm is
    below `max_norm`, else (g / norm) * max_norm in g's dtype.  Reads the
    norm on the host."""
    if norm is None:
        norm = global_norm(grads)
    if norm.item() < max_norm:
        return list(grads)
    return [g / norm.to(g.dtype) * _rounded(max_norm, g.dtype) for g in grads]


def _rounded(value: float, dtype: torch.dtype) -> float:
    """A Python constant as JAX applies it to an array: rounded to the
    array's dtype first (torch then computes in float32 with it, which
    rounds each result as the operation in that dtype would)."""
    return torch.tensor(value, dtype=dtype).item()


class Optimizer:
    """optax's chain(clip_by_global_norm, adam | adamw) over a list of
    parameters, with a learning-rate schedule of the update count.  `step()`
    reads each parameter's .grad (zero where it has none, as a gradient of
    JAX would be), clips, updates the parameters in place and returns the
    global norm of the raw gradients.  The update runs as foreach
    operations over the parameters of each dtype."""

    def __init__(self, params, learning_rate: Union[float, Schedule],
                 weight_decay: float = 0.0, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 grad_clip: Optional[float] = None):
        self.params = list(params)
        self.schedule = (learning_rate if callable(learning_rate)
                         else (lambda step, lr=learning_rate: lr))
        self.weight_decay, self.b1, self.b2, self.eps = (weight_decay, b1, b2,
                                                         eps)
        self.grad_clip = grad_clip
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in self.params]
        norm = global_norm(grads)
        if self.grad_clip:
            grads = clip_by_global_norm(grads, self.grad_clip, norm)
        lr = float(np.float32(self.schedule(self.count)))
        self.count += 1
        # optax's bias corrections: 1 - decay**count in float32, then
        # rounded to each moment's dtype
        bc1 = float(1 - np.float32(self.b1) ** np.float32(self.count))
        bc2 = float(1 - np.float32(self.b2) ** np.float32(self.count))
        groups: Dict[torch.dtype, list] = {}
        for i, p in enumerate(self.params):
            groups.setdefault(p.dtype, []).append(i)
        for dtype, idx in groups.items():
            def c(v, dtype=dtype):
                return _rounded(v, dtype)
            ps = [self.params[i] for i in idx]
            gs = [grads[i] for i in idx]
            mus = [self.mu[i] for i in idx]
            nus = [self.nu[i] for i in idx]
            # mu = (1 - b1) g + b1 mu;  nu = (1 - b2) g^2 + b2 nu
            torch._foreach_mul_(mus, c(self.b1))
            torch._foreach_add_(mus, torch._foreach_mul(gs, c(1 - self.b1)))
            sq = torch._foreach_mul(gs, gs)
            torch._foreach_mul_(sq, c(1 - self.b2))
            torch._foreach_mul_(nus, c(self.b2))
            torch._foreach_add_(nus, sq)
            del sq
            # u = (mu / bc1) / (sqrt(nu / bc2) + eps) [+ wd p];  p += -lr u
            u = torch._foreach_div(mus, c(bc1))
            den = torch._foreach_div(nus, c(bc2))
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, c(self.eps))
            torch._foreach_div_(u, den)
            del den
            if self.weight_decay:
                torch._foreach_add_(u, torch._foreach_mul(
                    ps, c(self.weight_decay)))
            torch._foreach_mul_(u, c(-lr))
            torch._foreach_add_(ps, u)
        return norm


def make_optimizer(model: nn.Module, learning_rate: Union[float, Schedule],
                   mask: Optional[Dict[str, bool]] = None,
                   weight_decay: float = 0.0, b1: float = 0.9,
                   b2: float = 0.999, eps: float = 1e-8,
                   grad_clip: Optional[float] = None) -> Optimizer:
    """The JAX make_optimizer: Adam / AdamW with an optional global-norm
    clip, over the parameters the mask marks trainable (all without one)."""
    params = [p for n, p in model.named_parameters()
              if mask is None or mask[n]]
    return Optimizer(params, learning_rate, weight_decay, b1, b2, eps,
                     grad_clip)
