"""TasteEngine: the serving engine's core around the composite TASTE model
(counterpart of the JAX serving/server.py `TasteEngine`, its token
bucketing, `tokenize`, `reconstruct` and the streaming entry points).

Requests are padded to the nearest token bucket, as in JAX, so one
streamer serves every request of a bucket.  A request's uint64 seed maps
to a `torch.Generator` (`reconstruct`) or to the streams' derived
generators (frontend/streaming.py) in place of JAX's host-built PRNG key.

Not ported yet (ROADMAP.md queue A, "The front end and serving"):
`complete`, `complete_batch`, `CompleteBatcher`, `run_load_test`, the gRPC
and HTTP servers and `from_pretrained`.
"""

from __future__ import annotations

import time
from typing import Any, Dict

import numpy as np
import torch

from taste_spokenlm_tpu_torch.frontend.streaming import (CompletionStreamer,
                                                         StreamingSynthesizer)
from taste_spokenlm_tpu_torch.models.sampler import SamplerConfig

SEED_MASK = 0xFFFFFFFFFFFFFFFF


class TasteEngine:
    """Model wrapper with shape bucketing and one cached streamer per
    bucket and geometry.  `model` is a TasteForCausalLM holding its
    weights, on the device it serves from."""

    def __init__(self, model, config, token_buckets=(16, 32, 64)):
        self.model = model
        self.config = config
        self.token_buckets = tuple(sorted(token_buckets))
        self._streamers: Dict[Any, Any] = {}

    @property
    def device(self) -> torch.device:
        return self.model.device

    def _bucket(self, n: int) -> int:
        for b in self.token_buckets:
            if n <= b:
                return b
        return self.token_buckets[-1]

    def _generator(self, seed) -> torch.Generator:
        """The request's generator: seeded with the uint64 seed."""
        return torch.Generator(device=self.device).manual_seed(
            int(seed) & SEED_MASK)

    def _pad_tokens(self, ids, word_ids, bucket):
        """-> (ids [1, bucket], lengths [1], word ids [1, bucket]) as int32
        numpy arrays, truncated to the bucket."""
        ids = list(ids)[:bucket]
        word_ids = list(word_ids)[:bucket]
        n = len(ids)
        pad = bucket - n
        ids = np.pad(np.asarray(ids, np.int32), (0, pad))
        word_ids = np.pad(np.asarray(word_ids, np.int32), (0, pad))
        return (ids[None], np.asarray([n], np.int32), word_ids[None])

    def _dev(self, *arrays, dtype=torch.long):
        return tuple(torch.as_tensor(np.asarray(a)).to(self.device, dtype)
                     for a in arrays)

    @torch.no_grad()
    def tokenize(self, mel: np.ndarray, asr_ids, asr_word_ids) -> np.ndarray:
        """whisper log-mel [n_mels, frames] + asr tokens -> taste indices
        [n, L] (n = the tokens that fit the bucket)."""
        bucket = self._bucket(len(asr_ids))
        ids, lens, words = self._dev(*self._pad_tokens(asr_ids, asr_word_ids,
                                                       bucket))
        (mel_t,) = self._dev(np.asarray(mel, np.float32)[None],
                             dtype=torch.float32)
        out = self.model.audio_tower(mel_t, ids, lens, words)
        return out["quantized_indices"][0, :len(asr_ids)].cpu().numpy()

    @torch.no_grad()
    def reconstruct(self, mel, asr_ids, asr_word_ids, spk, max_steps, seed):
        """-> (wav [n] f32, sample rate, S3 token count, RTF)."""
        bucket = self._bucket(len(asr_ids))
        mel_len_max = max(32, int(np.ceil(max_steps / 50 * 22050 / 256)) + 8)
        ids, lens, words = self._dev(*self._pad_tokens(asr_ids, asr_word_ids,
                                                       bucket))
        mel_t, spk_t = self._dev(np.asarray(mel, np.float32)[None],
                                 np.asarray(spk, np.float32)[None],
                                 dtype=torch.float32)
        t0 = time.perf_counter()
        out = self.model.inference_reconstruction(
            spk_t, ids, lens, words, mel_t, max_speech_steps=max_steps,
            mel_len_max=mel_len_max, generator=self._generator(seed))
        wav = out["waveform"][0].float().cpu().numpy()
        n = int(out["waveform_lengths"][0])
        wall = time.perf_counter() - t0
        sr = self.config.hift.sampling_rate
        rtf = wall / max(n / sr, 1e-6)
        return wav[:n], sr, int(out["speech_token_lengths"][0]), rtf

    def synthesize_stream(self, taste_indices, asr_ids, asr_word_ids, spk,
                          max_steps: int = 128, chunk_tokens: int = 50,
                          seed: int = 0):
        """Streaming synthesis: yields (wav_chunk [n] f32, is_last, n_new)
        as each ~chunk_tokens of S3 audio is vocoded.  The taste rows are
        padded to the token bucket (words <= asr tokens); one
        StreamingSynthesizer is cached per bucket and geometry."""
        bucket = self._bucket(len(asr_ids))
        taste = np.asarray(taste_indices, np.int32).reshape(
            -1, self.config.audio_tower.quantizer.num_quantizers)
        n_words = taste.shape[0]
        taste_pad = np.zeros((1, bucket, taste.shape[1]), np.int32)
        taste_pad[0, :min(n_words, bucket)] = np.maximum(taste[:bucket], 0)
        key = ("synthesize_stream", bucket, max_steps, chunk_tokens)
        if key not in self._streamers:
            self._streamers[key] = StreamingSynthesizer(
                self.model, chunk_tokens=chunk_tokens,
                left_ctx_tokens=max(chunk_tokens // 2, 1),
                max_speech_steps=max_steps)
        streamer = self._streamers[key]
        ids, lens, words = self._pad_tokens(asr_ids, asr_word_ids, bucket)
        (spk_t,) = self._dev(np.asarray(spk, np.float32)[None],
                             dtype=torch.float32)
        it = streamer.stream(seed, spk_t, *self._dev(taste_pad, ids, lens,
                                                     words))
        for out in it:
            yield out["wav"][0], bool(out["is_last"]), int(out["n_new"])

    def _get_tables(self):
        """Sampler tables; without a tokenizer asset, trivial ones."""
        if not hasattr(self, "_tables"):
            v = self.config.spoken_lm.llama.vocab_size
            self._tables = {
                "word_start": torch.from_numpy(np.arange(v) % 3 == 0),
                "banned": torch.zeros((v,), dtype=torch.bool),
                "sentence_end": torch.from_numpy(np.arange(v) % 7 == 0)}
            self._tables = {k: t.to(self.device)
                            for k, t in self._tables.items()}
        return self._tables

    def complete_stream(self, llm_ids, llm_word_ids, llm_indices,
                        asr_ids, asr_word_ids, spk, sampler_kwargs,
                        seed, max_steps: int = 64,
                        max_speech_steps: int = 128, chunk_tokens: int = 50,
                        first_chunk_tokens: int = 16,
                        jd_first_chunk: int = 16):
        """PIPELINED completion: yields (wav_chunk [n] f32, is_last, n_new,
        n_words) with the first chunk after only a partial joint decode.
        `asr_ids` / `asr_word_ids` are the full-budget asr tokenization of
        the completion text (word w of the decode = the asr positions with
        word id w)."""
        bucket = self._bucket(len(llm_ids))
        asr_bucket = self._bucket(len(asr_ids))
        scfg = SamplerConfig(delay=self.config.spoken_lm.delay,
                             **sampler_kwargs)
        fc = min(first_chunk_tokens, chunk_tokens)
        key = ("complete_stream", bucket, asr_bucket, max_steps,
               max_speech_steps, chunk_tokens, fc, jd_first_chunk, scfg)
        if key not in self._streamers:
            self._streamers[key] = CompletionStreamer(
                self.model, scfg, self._get_tables(),
                chunk_tokens=chunk_tokens,
                left_ctx_tokens=max(chunk_tokens // 2, 1),
                first_chunk_tokens=fc, jd_first_chunk=jd_first_chunk,
                jd_chunk=max(jd_first_chunk, 1),
                max_speech_steps=max_speech_steps)
        streamer = self._streamers[key]
        ids, lens, words = self._pad_tokens(llm_ids, llm_word_ids, bucket)
        nq = self.config.audio_tower.quantizer.num_quantizers
        ridx = np.asarray(llm_indices, np.int32).reshape(-1, nq)[:bucket]
        idx = np.full((1, bucket, nq), -1, np.int32)
        idx[0, :len(ridx)] = ridx
        a_ids, _, a_words = self._pad_tokens(asr_ids, asr_word_ids,
                                             asr_bucket)
        (spk_t,) = self._dev(np.asarray(spk, np.float32)[None],
                             dtype=torch.float32)
        it = streamer.stream(
            seed, spk_t, *self._dev(idx, ids, lens, words, a_ids, a_words),
            max_steps=max_steps,
            asr_valid_len=min(len(asr_ids), asr_bucket))
        for out in it:
            yield (out["wav"][0], bool(out["is_last"]), int(out["n_new"]),
                   int(out["n_words"]))
