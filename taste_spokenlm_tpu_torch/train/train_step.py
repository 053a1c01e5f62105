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

Under a data-parallel group (parallel/mesh.py) a step takes the data
rank's rows of the global batch and runs within `mesh.data_parallel()`:
the forward's means are the rank's shares of the global ones, and the step
sums its metrics over the data group, so every rank returns the global
batch's.  `draws` are then the rank's own rows (the dead-code picks: rows
of the global batch).  On a ("data", "model") mesh the parameters stay
replicated along "model", as JAX's `state_shardings` keeps them: the ranks
of a model group take the same rows and compute the same step, and
nothing is summed over the model group.

`TrainState.state_dict()` is what a checkpoint holds, JAX's TrainState
(utils/checkpoint.py): the model's parameters and buffers (the RVQ's EMA
codebooks among them), the optimizer's moments and count, the step and the
generator's state.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch

from taste_spokenlm_tpu_torch.ops.losses import IGNORE_ID, masked_accuracy
from taste_spokenlm_tpu_torch.parallel import mesh
from taste_spokenlm_tpu_torch.train.optim import Optimizer, apply_mask
from taste_spokenlm_tpu_torch.utils import profiling

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

    def state_dict(self) -> Dict:
        """{"model", "optimizer", "step", "generator"}; the optimizer's
        moments whole (a collective under a data-parallel group)."""
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "step": self.step,
                "generator": (None if self.generator is None
                              else self.generator.get_state())}

    def load_state_dict(self, state: Dict) -> None:
        """Restore `state_dict()` in place (strict over the model)."""
        self.model.load_state_dict(state["model"], strict=True)
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])
        if self.generator is not None:
            self.generator.set_state(state["generator"])


def _global(metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The ranks' shares of each mean summed (the metrics themselves in one
    process)."""
    return {k: mesh.global_sum(v) for k, v in metrics.items()}


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


def _traced(step):
    """The step under the tracer's span `train.step`."""
    @functools.wraps(step)
    def traced(*args, **kwargs):
        with profiling.span("train.step"):
            return step(*args, **kwargs)
    return traced


def _update(optimizer: Optimizer, forward: Callable[[], Dict]):
    """The step's forward (gradients zeroed first), backward and optimizer
    update, under the spans `train.forward`, `train.backward` and
    `train.optimizer` -> (the forward's outputs, the raw gradients' global
    norm)."""
    with profiling.span("train.forward"):
        optimizer.zero_grad()
        out = forward()
    with profiling.span("train.backward"):
        out["loss"].backward()
    with profiling.span("train.optimizer"):
        grad_norm = optimizer.step()
    return out, grad_norm


def make_stage1_step(model, optimizer: Optimizer, skip_vq: bool = False,
                     skip_audio_in_decoder: bool = False,
                     trainable_mask: Optional[Dict[str, bool]] = None
                     ) -> Callable[..., Dict[str, torch.Tensor]]:
    """-> step(batch, draws=None) -> metrics {loss, speech_token_accuracy,
    commit_loss (unless skip_vq), grad_norm}, 0-d tensors on the model's
    device.  `trainable_mask` (default: the optimizer's parameters) sets
    requires_grad on every parameter; `step.state` is the TrainState."""
    state = _train_state(model, optimizer, trainable_mask)

    @mesh.data_parallel()
    @_traced
    def step(batch, draws: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
        out, grad_norm = _update(optimizer, lambda: (
            model.forward_speech_autoencoder(
                *(batch[k] for k in BATCH_KEYS), train=True,
                generator=state.generator, skip_vq=skip_vq,
                skip_audio_in_decoder=skip_audio_in_decoder, draws=draws)))
        state.step += 1
        metrics = {"loss": out["loss"].detach(),
                   "speech_token_accuracy": out["speech_token_accuracy"]}
        if "commit_loss" in out:
            metrics["commit_loss"] = out["commit_loss"].detach()
        metrics = _global(metrics)
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

    @mesh.data_parallel()
    @_traced
    def step(batch, draws: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
        out, grad_norm = _update(optimizer, lambda: model.forward_spoken_llm(
            *(batch[k] for k in STAGE2_KEYS), train=True,
            eps=(draws or {}).get("eps"), generator=state.generator,
            ref_logits=batch.get("ref_logits") if use_ref_kl else None,
            compute_ref_kl=use_ref_kl, return_text_logits=False))
        state.step += 1
        metrics = _global({k: out[k].detach() for k in (
            "loss", "text_loss", "taste_loss", "text_kl") if k in out})
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

    @mesh.data_parallel()
    @_traced
    def step(batch, draws: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
        out, grad_norm = _update(optimizer, lambda: flow(
            *(batch[k] for k in FLOW_KEYS), generator=state.generator,
            **(draws or {})))
        state.step += 1
        return {"loss": mesh.global_sum(out["loss"].detach()),
                "grad_norm": grad_norm}

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
