"""The train steps (counterpart of the JAX train/train_step.py
`make_stage1_step`, `make_stage2_step`, `make_flow_step`,
`eval_metrics_stage2` and `TrainState`).

One step: the forward in train mode, the backward, the global norm of the
raw gradients, the clip and the Adam update.  Frozen parameters get
requires_grad_(False), so no gradient is formed for them; a fully frozen
whisper encoder runs under no_grad, as the JAX step's stop_gradient and
dead-code elimination leave it.  The JAX step's random draws come from its
split key; here they come from the state's torch.Generator (seeded 0, as
the JAX state's key is PRNGKey(0) in bench.py), or are passed in per step
(`draws`) so that a test can hand both sides the same draws.

- Stage 1, the speech autoencoder: decoder CE + weight_commit_loss x
  commit, the RVQ's EMA update written to its buffers.  The curriculum's
  phases: text_only sets skip_vq and skip_audio_in_decoder, no_vq sets
  skip_vq.  `draws` as TasteAudioTower.forward takes them.
- Stage 2, the spoken LM: text CE (with `use_ref_kl`, the KL to the
  frozen base, adapters off, in the same step) + the taste loss, CE + KL
  in time chunks.  `draws`: {"eps"}, the continue-latent bridge's noise.
- The flow (MaskedDiffWithXvec): the OT-CFM loss on unfused DiT blocks.
  `draws`: {"t", "z", "keep"} (ConditionalCFM.compute_loss).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch

from taste_spokenlm_tpu_torch.ops.losses import IGNORE_ID, masked_accuracy
from taste_spokenlm_tpu_torch.train.optim import Optimizer, apply_mask

BATCH_KEYS = ("speaker_embeds", "asr_token_ids", "asr_token_lengths",
              "asr_word_ids", "audio_features", "speech_token_ids",
              "speech_token_lengths")
STAGE2_KEYS = ("llm_indices", "llm_token_ids", "llm_token_lengths",
               "llm_word_ids")
FLOW_KEYS = ("speech_token_ids", "speech_token_lengths", "feat",
             "feat_lengths", "embedding")


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: Optimizer
    step: int = 0
    generator: Optional[torch.Generator] = None


def _train_state(model, optimizer: Optimizer,
                 trainable_mask: Optional[Dict[str, bool]]) -> TrainState:
    """requires_grad per `trainable_mask` (default: the optimizer's
    parameters) and a TrainState with a generator seeded 0."""
    if trainable_mask is None:
        held = {id(p) for p in optimizer.params}
        trainable_mask = {n: id(p) in held for n, p in model.named_parameters()}
    apply_mask(model, trainable_mask)
    dev = next(model.parameters()).device
    return TrainState(model, optimizer, 0,
                      torch.Generator(device=dev).manual_seed(0))


def make_stage1_step(model, optimizer: Optimizer, skip_vq: bool = False,
                     skip_audio_in_decoder: bool = False,
                     trainable_mask: Optional[Dict[str, bool]] = None
                     ) -> Callable[..., Dict[str, torch.Tensor]]:
    """-> step(batch, draws=None) -> metrics {loss, speech_token_accuracy,
    commit_loss (unless skip_vq), grad_norm}, 0-d tensors on the model's
    device.  `trainable_mask` (default: the optimizer's parameters) sets
    requires_grad on every parameter; `step.state` is the TrainState."""
    state = _train_state(model, optimizer, trainable_mask)

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


def make_stage2_step(model, optimizer: Optimizer, use_ref_kl: bool = False,
                     trainable_mask: Optional[Dict[str, bool]] = None
                     ) -> Callable[..., Dict[str, torch.Tensor]]:
    """The stage-2 joint-LM step over `forward_spoken_llm` in train mode
    with chunked CE (+ KL): -> step(batch, draws=None) -> metrics {loss,
    text_loss, taste_loss, text_kl (with a teacher), grad_norm}.
    `use_ref_kl`: the KL's teacher is `batch["ref_logits"]` when the batch
    has it, else the frozen base in the same step.  `trainable_mask` (e.g.
    optim.lora_only_mask) as in make_stage1_step."""
    state = _train_state(model, optimizer, trainable_mask)

    def step(batch, draws: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
        optimizer.zero_grad()
        out = model.forward_spoken_llm(
            *(batch[k] for k in STAGE2_KEYS), train=True,
            eps=(draws or {}).get("eps"), generator=state.generator,
            ref_logits=batch.get("ref_logits") if use_ref_kl else None,
            compute_ref_kl=use_ref_kl, return_text_logits=False)
        out["loss"].backward()
        grad_norm = optimizer.step()
        state.step += 1
        metrics = {k: out[k].detach() for k in ("loss", "text_loss",
                                                 "taste_loss", "text_kl")
                   if k in out}
        metrics["grad_norm"] = grad_norm
        return metrics

    step.state = state
    return step


def make_flow_step(flow, optimizer: Optimizer,
                   trainable_mask: Optional[Dict[str, bool]] = None
                   ) -> Callable[..., Dict[str, torch.Tensor]]:
    """The flow-matching step over MaskedDiffWithXvec: -> step(batch,
    draws=None) -> metrics {loss, grad_norm}.  Batch keys: FLOW_KEYS
    (`feat` [B, Tm, M] from ops/audio.flow_mel, `embedding` [B, spk])."""
    state = _train_state(flow, optimizer, trainable_mask)

    def step(batch, draws: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
        optimizer.zero_grad()
        out = flow(*(batch[k] for k in FLOW_KEYS), generator=state.generator,
                   **(draws or {}))
        out["loss"].backward()
        grad_norm = optimizer.step()
        state.step += 1
        return {"loss": out["loss"].detach(), "grad_norm": grad_norm}

    step.state = state
    return step


def eval_metrics_stage2(out: Dict, num_levels: int = 4) -> Dict:
    """The reference's stage-2 eval metrics from a forward with text
    logits: text accuracy and per-level taste accuracy a0..a{L-1}."""
    metrics = {"text_accuracy": masked_accuracy(out["text_logits"],
                                                out["text_labels"], IGNORE_ID)}
    for level in range(num_levels):
        metrics[f"a{level}_accuracy"] = masked_accuracy(
            out["taste_logits"][..., level, :], out["taste_labels"][..., level])
    return metrics
