"""The stage-1 train step (counterpart of the JAX train/train_step.py
`make_stage1_step` and `TrainState`).

One step: the speech-autoencoder forward in train mode (decoder CE +
weight_commit_loss x commit, the RVQ's EMA update written to its buffers),
the backward, the global norm of the raw gradients, the clip and the Adam
update.  Frozen parameters get requires_grad_(False), so no gradient is
formed for them; a fully frozen whisper encoder runs under no_grad, as the
JAX step's stop_gradient and dead-code elimination leave it.  The JAX
step's random draws come from its split key; here they come from the
state's torch.Generator (seeded 0, as the JAX state's key is
PRNGKey(0) in bench.py), or are passed in per step (`draws`, as
TasteAudioTower.forward takes them) so that a test can hand both sides the
same draws.  The phases of the stage-1 curriculum: text_only sets
skip_vq and skip_audio_in_decoder, no_vq sets skip_vq.

The stage-2 step and the flow step are not ported yet (ROADMAP.md queue
A, "The stage-2 step and the teacher-forced spoken LM" and "The flow
OT-CFM step").
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch

from taste_spokenlm_tpu_torch.train.optim import Optimizer, apply_mask

BATCH_KEYS = ("speaker_embeds", "asr_token_ids", "asr_token_lengths",
              "asr_word_ids", "audio_features", "speech_token_ids",
              "speech_token_lengths")


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: Optimizer
    step: int = 0
    generator: Optional[torch.Generator] = None


def make_stage1_step(model, optimizer: Optimizer, skip_vq: bool = False,
                     skip_audio_in_decoder: bool = False,
                     trainable_mask: Optional[Dict[str, bool]] = None
                     ) -> Callable[..., Dict[str, torch.Tensor]]:
    """-> step(batch, draws=None) -> metrics {loss, speech_token_accuracy,
    commit_loss (unless skip_vq), grad_norm}, 0-d tensors on the model's
    device.  `trainable_mask` (default: the optimizer's parameters) sets
    requires_grad on every parameter; `step.state` is the TrainState."""
    if trainable_mask is None:
        held = {id(p) for p in optimizer.params}
        trainable_mask = {n: id(p) in held for n, p in model.named_parameters()}
    apply_mask(model, trainable_mask)
    dev = next(model.parameters()).device
    state = TrainState(model, optimizer, 0,
                       torch.Generator(device=dev).manual_seed(0))

    def step(batch, draws: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
        optimizer.zero_grad()
        out = model.forward_speech_autoencoder(
            *(batch[k] for k in BATCH_KEYS), train=True,
            generator=state.generator, skip_vq=skip_vq,
            skip_audio_in_decoder=skip_audio_in_decoder, draws=draws)
        out["loss"].backward()
        grad_norm = optimizer.step()
        state.step += 1
        metrics = {"loss": out["loss"].detach(),
                   "speech_token_accuracy": out["speech_token_accuracy"]}
        if "commit_loss" in out:
            metrics["commit_loss"] = out["commit_loss"].detach()
        metrics["grad_norm"] = grad_norm
        return metrics

    step.state = state
    return step
