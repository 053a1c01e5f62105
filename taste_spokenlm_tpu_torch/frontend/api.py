"""High-level inference API: the whole speech-continuation pipeline
(counterpart of the JAX frontend/api.py).

The joint decode runs on the device (TasteForCausalLM.generate_completion);
this module does the tokenizer round trip on the host (the generated llm
tokens decoded to words, the words encoded again with the asr tokenizer,
sharing word ids), joins the conditioning prefix and the continuation, and
runs the synthesis tail (taste indices + asr tokens -> waveform).

Draws: the decode from a generator seeded `seed`, the synthesis from one
seeded `seed + 1`, each on the model's device.  `draws` hands in the noise
instead (the tests give both frameworks the same numbers): "text_gumbel" /
"taste_gumbel" for the decode, "gumbel" / "z" / "source_phase" /
"source_noise" for the synthesis, as generate_completion and
synthesize_from_taste take them.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch

from taste_spokenlm_tpu_torch.models.sampler import (SamplerConfig,
                                                     build_sampler_tables)

SEED_MASK = 0xFFFFFFFFFFFFFFFF
DECODE_DRAWS = ("text_gumbel", "taste_gumbel")
SYNTHESIS_DRAWS = ("gumbel", "z", "source_phase", "source_noise")


def _pad_to(x: np.ndarray, n: int, value=0) -> np.ndarray:
    pad = [(0, n - x.shape[0])] + [(0, 0)] * (x.ndim - 1)
    return np.pad(x, pad, constant_values=value)


def build_instruct_ids(llm_tokenizer, system_prompt: Optional[str] = None):
    """Chat-template wrapper ids for `conditional_mode='instruct'`.

    Renders a user turn whose content is a sentinel with the tokenizer's
    own chat template (a llama-2-instruct wrapper when it has none), splits
    the text around the sentinel and encodes the two halves: prefix =
    everything before the audio content, suffix = everything after (the
    assistant-generation header); stop_id = the tokenizer's eos id.

    Returns (prefix_ids [P] int32, suffix_ids [S] int32, stop_id int)."""
    marker = "␟"  # SYMBOL FOR UNIT SEPARATOR: survives any template
    msgs = []
    if system_prompt:
        msgs.append({"role": "system", "content": system_prompt})
    msgs.append({"role": "user", "content": marker})
    try:
        text = llm_tokenizer.apply_chat_template(
            msgs, tokenize=False, add_generation_prompt=True)
    except Exception:
        # a tokenizer without a chat template (any failure of the call):
        # the llama-2-instruct wrapper
        sys_part = f"<<SYS>>\n{system_prompt}\n<</SYS>>\n\n" \
            if system_prompt else ""
        text = f"[INST] {sys_part}{marker} [/INST]"
    pre, _, post = text.partition(marker)
    prefix = list(llm_tokenizer.encode(pre, add_special_tokens=False))
    suffix = list(llm_tokenizer.encode(post, add_special_tokens=False))
    if not prefix:  # generate() embeds the prefix; keep it non-empty
        bos = getattr(llm_tokenizer, "bos_token_id", None)
        prefix = [bos if bos is not None else 0]
    if not suffix:
        suffix = list(prefix[-1:])
    stop_id = getattr(llm_tokenizer, "eos_token_id", None)
    return (np.asarray(prefix, np.int32), np.asarray(suffix, np.int32),
            int(stop_id) if stop_id is not None else -1)


@dataclass
class CompletionPipeline:
    """`model` is a TasteForCausalLM on the device it runs on; `tables`
    the sampler's bool tables (numpy or tensors), built from the llm
    tokenizer when not given."""

    model: Any
    llm_tokenizer: Any
    asr_tokenizer: Any
    tables: Optional[Dict] = None
    max_decode_steps: int = 256
    max_asr_tokens: int = 128
    max_words: int = 128
    max_speech_steps: int = 512
    mel_len_max: int = 512

    def __post_init__(self):
        if self.tables is None:
            vocab = self.model.config.spoken_lm.llama.vocab_size
            self.tables = build_sampler_tables(self.llm_tokenizer, vocab)
        self.tables = {k: torch.as_tensor(v).to(self.device)
                       for k, v in self.tables.items()}

    @property
    def device(self) -> torch.device:
        return self.model.device

    def _long(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x)).to(self.device, torch.long)

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(
            int(seed) & SEED_MASK)

    @torch.no_grad()
    def __call__(
        self,
        speaker_embeds: np.ndarray,           # [1, spk]
        llm_token_ids: np.ndarray,            # [1, T]
        llm_word_ids: np.ndarray,             # [1, T]
        llm_indices: np.ndarray,              # [1, T, L]
        asr_token_ids: Optional[np.ndarray] = None,   # [1, Ta]
        asr_word_ids: Optional[np.ndarray] = None,
        conditional_mode: str = "audio",
        out_generated_part_only: bool = False,
        extra_words: int = 8,
        text_top_p: float = 0.3,
        taste_top_p: float = 0.0,
        temperature: float = 0.5,
        repetition_penalty: float = 1.1,
        seed: int = 0,
        output_text_only: bool = False,
        instruct_prefix_ids: Optional[np.ndarray] = None,
        instruct_suffix_ids: Optional[np.ndarray] = None,
        stop_id: int = -1,
        system_prompt: Optional[str] = None,
        draws: Optional[Dict[str, Any]] = None,
    ) -> Dict[str, Any]:
        cfg = self.model.config
        draws = draws or {}
        instruct_kwargs = {}
        if conditional_mode == "instruct":
            if instruct_prefix_ids is None:
                instruct_prefix_ids, instruct_suffix_ids, tmpl_stop = \
                    build_instruct_ids(self.llm_tokenizer, system_prompt)
                if stop_id < 0:
                    stop_id = tmpl_stop
            instruct_kwargs = dict(
                instruct_prefix_ids=self._long(instruct_prefix_ids),
                instruct_suffix_ids=self._long(instruct_suffix_ids))
        scfg = SamplerConfig(
            delay=cfg.spoken_lm.delay, delay_level=cfg.spoken_lm.delay_level,
            extra_words=extra_words, text_top_p=text_top_p,
            taste_top_p=taste_top_p, text_temperature=temperature,
            repetition_penalty=repetition_penalty,
            stop_id=stop_id if conditional_mode == "instruct" else -1,
            has_prefix=conditional_mode == "audio")

        t = llm_token_ids.shape[1]
        gen = self.model.generate_completion(
            scfg, self.tables, self._long(llm_indices),
            self._long(llm_token_ids), self._long([t]),
            self._long(llm_word_ids), conditional_mode,
            self.max_decode_steps, **instruct_kwargs,
            generator=self._generator(seed),
            **{k: draws[k] for k in DECODE_DRAWS if k in draws})

        n = int(gen["num_tokens"][0])
        n_taste = int(gen["num_taste_words"][0])
        gen_ids = gen["llm_token_ids"][0, :n].cpu().numpy().astype(np.int32)
        gen_words = gen["llm_word_ids"][0, :n].cpu().numpy().astype(np.int32)
        gen_taste = gen["taste_indices"][0, :n_taste].cpu().numpy().astype(
            np.int32)

        generated_text = self.llm_tokenizer.decode(gen_ids.tolist()).strip()
        if output_text_only:
            return {"generated_text": generated_text}

        # the generated words encoded with the asr tokenizer, sharing ids
        words = [" " + w for w in re.split(r"\s", generated_text) if w]
        gen_asr_ids, gen_asr_words = [], []
        for i, word in enumerate(words):
            for tid in self.asr_tokenizer.encode(word, add_special_tokens=False):
                gen_asr_ids.append(tid)
                gen_asr_words.append(i)
        gen_asr_ids = np.asarray(gen_asr_ids, np.int32)
        gen_asr_words = np.asarray(gen_asr_words, np.int32)

        # dense per-word taste for the joined sequence
        if out_generated_part_only or conditional_mode != "audio":
            asr_ids, asr_words = gen_asr_ids, gen_asr_words
            word_taste = gen_taste
        else:
            # the prefix: its word-start rows of llm_indices are the
            # per-word taste (the others are -1)
            orig = np.asarray(llm_indices[0])
            orig_word_taste = orig[orig[:, 0] >= 0]
            base = asr_word_ids[0].max() + 1
            asr_ids = np.concatenate([asr_token_ids[0], gen_asr_ids])
            asr_words = np.concatenate([asr_word_ids[0],
                                        base + gen_asr_words])
            word_taste = np.concatenate([orig_word_taste, gen_taste], axis=0)

        na = min(len(asr_ids), self.max_asr_tokens)
        nw = word_taste.shape[0]
        asr_ids_p = _pad_to(asr_ids[:na], self.max_asr_tokens)[None]
        asr_words_p = _pad_to(np.minimum(asr_words[:na], max(nw - 1, 0)),
                              self.max_asr_tokens)[None]
        taste_p = _pad_to(word_taste, max(self.max_words, nw))[None]

        out = self.model.synthesize_from_taste(
            torch.as_tensor(np.asarray(speaker_embeds, np.float32)).to(
                self.device),
            self._long(taste_p), self._long(asr_ids_p), self._long([na]),
            self._long(asr_words_p), max_speech_steps=self.max_speech_steps,
            mel_len_max=self.mel_len_max,
            generator=self._generator(int(seed) + 1),
            **{k: draws[k] for k in SYNTHESIS_DRAWS if k in draws})

        return {
            "generated_text": generated_text,
            "generated_llm_token_ids": gen_ids,
            "generated_word_ids": gen_words,
            "generated_taste": gen_taste,
            "speech_token_ids": out["speech_token_ids"].cpu().numpy(),
            "speech_token_lengths": out["speech_token_lengths"].cpu().numpy(),
            "waveform": out["waveform"].float().cpu().numpy(),
            "waveform_lengths": out["waveform_lengths"].cpu().numpy(),
        }
