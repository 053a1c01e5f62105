"""The joint text + taste decode controller as branchless tensor state
(counterpart of the JAX models/sampler.py).

The vocabulary scans (word-start, banned and sentence-end token sets) are
bool tables [V] built once on the host; the countdown / wait-for-taste /
terminate logic is a small integer state updated with torch.where, batched
over the rows [B]; actions come back as flags.  Random draws are Gumbel
noise passed in per step, one tensor for the text logits and one for the
taste logits (argmax(logits + noise) is `jax.random.categorical`).
"""

from __future__ import annotations

import re
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from taste_spokenlm_tpu_torch.ops.sampling import (NEG_INF,
                                                   apply_repetition_penalty,
                                                   mask_top_p,
                                                   temperature_scale)

IGNORE_ID = -1


def build_sampler_tables(llm_tokenizer, vocab_size: int):
    """Host-side vocabulary scans: dict of bool numpy arrays [V]
    word_start, banned, sentence_end (the port's copy of the JAX
    package's function; `llm_tokenizer` needs only `decode(i)`)."""
    word_start = np.zeros(vocab_size, bool)
    banned = np.zeros(vocab_size, bool)
    sentence_end = np.zeros(vocab_size, bool)
    for i in range(vocab_size):
        sub = llm_tokenizer.decode(i)
        if i >= 128000:
            word_start[i] = True
        elif len(sub) > 0 and sub[0] == " ":
            word_start[i] = True
        if "." in sub:
            sentence_end[i] = True
        if sub != ".":
            if not re.search(r"[.,'a-zA-Z0-9]", sub):
                banned[i] = True
            elif "\n" in sub:
                banned[i] = True
    if vocab_size > 128001:
        banned[128001] = True  # llama eos
    return {"word_start": word_start, "banned": banned,
            "sentence_end": sentence_end}


class SamplerConfig(NamedTuple):
    delay: int = 1
    delay_level: str = "word"
    text_top_p: float = 0.0
    taste_top_p: float = 0.0
    text_temperature: float = 1.0
    repetition_penalty: float = 1.0
    extra_words: int = 8
    max_words_factor: int = 3
    stop_id: int = -1              # < 0: disabled
    has_prefix: bool = True


class SamplerState(NamedTuple):
    step: torch.Tensor              # [B] int, update() calls so far
    word_counter: torch.Tensor      # [B] int
    end_text_sampling: torch.Tensor  # [B] bool
    end_countdown: torch.Tensor     # [B] int, -1: not started
    word_start_count: torch.Tensor  # [B] int
    history: torch.Tensor           # [B, delay + 1] rolling word-start flags
    token_counts: torch.Tensor      # [B, V] emitted-token counts


def init_state(batch: int, vocab_size: int, delay: int, device=None
               ) -> SamplerState:
    z = torch.zeros((batch,), dtype=torch.long, device=device)
    return SamplerState(z, z, torch.zeros_like(z, dtype=torch.bool), z - 1, z,
                        torch.zeros((batch, delay + 1), dtype=torch.bool,
                                    device=device),
                        torch.zeros((batch, vocab_size), dtype=torch.long,
                                    device=device))


class StepOutput(NamedTuple):
    text_id: torch.Tensor           # [B]
    taste_ids: torch.Tensor         # [B, L] (IGNORE_ID when not sampled)
    terminate: torch.Tensor         # [B] bool
    wait_for_taste: torch.Tensor
    is_word_start: torch.Tensor
    taste_sample: torch.Tensor      # the 'sample' action
    use_prefix: torch.Tensor        # consume one pending prefix embed
    emit_text: torch.Tensor         # text id appended to the output
    taste_started: torch.Tensor


def sampler_step(state: SamplerState, text_logits: torch.Tensor,
                 taste_logits: torch.Tensor, cfg: SamplerConfig, tables,
                 text_noise: Optional[torch.Tensor] = None,
                 taste_noise: Optional[torch.Tensor] = None
                 ) -> Tuple[SamplerState, StepOutput]:
    """One decode step for every row.  text_logits [B, V]; taste_logits
    [B, L, K]; tables: bool tensors [V]; text_noise [B, V] and taste_noise
    [B, L, K] Gumbel noise, needed only where top_p > 0."""
    b = text_logits.shape[0]
    rows = torch.arange(b, device=text_logits.device)
    logits = torch.where(tables["banned"], text_logits.new_tensor(NEG_INF),
                         text_logits.float())
    if cfg.text_top_p == 0.0:
        text_id = torch.argmax(logits, dim=-1)
    else:
        filt = mask_top_p(logits, cfg.text_top_p)
        filt = apply_repetition_penalty(filt, state.token_counts,
                                        cfg.repetition_penalty)
        filt = temperature_scale(filt, cfg.text_temperature)
        text_id = torch.argmax(filt + text_noise, dim=-1)

    is_wait = state.end_text_sampling
    started_countdown = state.end_countdown >= 0
    new_countdown = torch.where(
        is_wait, torch.where(started_countdown, state.end_countdown - 1,
                             torch.full_like(state.end_countdown, cfg.delay - 1)),
        state.end_countdown)
    is_word_start = (state.word_counter == 0) | is_wait \
        | tables["word_start"][text_id]
    history = torch.roll(state.history, -1, dims=-1)
    history[:, -1] = is_word_start
    end_now = ((state.word_counter >= cfg.extra_words)
               & tables["sentence_end"][text_id]) \
        | (state.word_counter >= cfg.extra_words * cfg.max_words_factor)
    new_end_text = state.end_text_sampling | end_now
    if cfg.stop_id >= 0:
        hit_stop = text_id == cfg.stop_id
        new_end_text = new_end_text | hit_stop
        new_countdown = torch.where(hit_stop, torch.full_like(
            new_countdown, cfg.delay - 1), new_countdown)
        is_wait = is_wait | hit_stop
    new_word_counter = state.word_counter + is_word_start.long()
    new_ws_count = state.word_start_count + is_word_start.long()
    terminate = new_countdown == 0

    if cfg.delay_level == "token":
        started = state.step + 1 > cfg.delay
        is_taste = started & history[:, 0]
    else:
        started = new_ws_count > cfg.delay
        is_taste = started & is_word_start
    if cfg.taste_top_p == 0.0:
        taste_ids = torch.argmax(taste_logits, dim=-1)
    else:
        filt = mask_top_p(taste_logits.float(), cfg.taste_top_p)
        taste_ids = torch.argmax(filt + taste_noise, dim=-1)
    taste_ids = torch.where(is_taste[:, None], taste_ids,
                            torch.full_like(taste_ids, IGNORE_ID))

    prefix_gate = (torch.ones_like(is_word_start) if cfg.delay_level == "token"
                   else is_word_start)
    use_prefix = ~started & prefix_gate & bool(cfg.has_prefix)
    emit_text = ~is_wait & ~terminate
    counts = state.token_counts.clone()
    counts[rows, text_id] += 1
    new_state = SamplerState(state.step + 1, new_word_counter, new_end_text,
                             new_countdown, new_ws_count, history, counts)
    return new_state, StepOutput(text_id, taste_ids, terminate, is_wait,
                                 is_word_start, is_taste, use_prefix,
                                 emit_text, started)
