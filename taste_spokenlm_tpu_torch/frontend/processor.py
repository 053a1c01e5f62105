"""TasteProcessor: raw audio + text -> model inputs (counterpart of the JAX
frontend/processor.py).

The signal processing (resampling, the whisper 128-mel, the kaldi fbank of
the speaker path) is the batched frontend of ops/audio.py on the
processor's device; the speaker embedder, the S3 tokenizer and the ASR
transcriber are pluggable callables that take and return numpy arrays.

Dual tokenization with shared word ids: words are split on whitespace,
each prefixed with ' ', and encoded with both the whisper ("asr") and the
llama ("llm") tokenizers; every sub-token carries its word index, so the
tokenizer tower can pool to word level and the spoken LM can align the two
token spaces.

`speaker_embedder_from_onnx` and `s3_tokenizer_from_onnx` make the
speaker and S3 hooks from the reference's ONNX graphs, run by
frontend/onnx_exec.py on a device.
"""

from __future__ import annotations

import re
import zlib
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from taste_spokenlm_tpu_torch.config import AudioFrontendConfig
from taste_spokenlm_tpu_torch.device import resolve_device
from taste_spokenlm_tpu_torch.ops import audio as A


def speaker_embedder_from_onnx(path_or_bytes, device=None) -> Callable:
    """campplus.onnx / speaker_embed.onnx -> a `speaker_embedder` hook.

    The reference's onnxruntime call: one positional input, the [B, T, 80]
    mean-normalized kaldi fbank; returns the flat 192-d x-vector (numpy
    f32).  The graph runs on `device` (None: CUDA) with TF32 off."""
    from taste_spokenlm_tpu_torch.frontend.onnx_exec import OnnxTorchFunction
    fn = OnnxTorchFunction.from_file(path_or_bytes, device=device)

    def embed(feats):
        out = fn(np.asarray(_numpy(feats), np.float32))
        if isinstance(out, list):
            out = out[0]
        return np.asarray(_numpy(out), np.float32).reshape(-1)

    return embed


def s3_tokenizer_from_onnx(path_or_bytes, device=None) -> Callable:
    """speech_tokenizer_v1.onnx -> an `s3_tokenizer` hook.

    The reference's onnxruntime call: positional inputs (mel [1, 128, T <=
    3000], length int32 [1]); returns the flat int32 S3 ids (4096-way, 50
    Hz).  The graph runs on `device` (None: CUDA) with TF32 off."""
    from taste_spokenlm_tpu_torch.frontend.onnx_exec import OnnxTorchFunction
    fn = OnnxTorchFunction.from_file(path_or_bytes, device=device)

    def tokenize(mel, n_valid_frames):
        feats = np.asarray(_numpy(mel), np.float32)[:, :, :int(n_valid_frames)]
        out = fn(feats, np.asarray([feats.shape[2]], np.int32))
        if isinstance(out, list):
            out = out[0]
        return _numpy(out).reshape(-1).astype(np.int32)

    return tokenize


def transcribe_with_fallback(asr_apply, mel, tokenizer=None,
                             max_tokens: int = 224,
                             temperatures=(0.0, 0.2, 0.4, 0.6, 0.8, 1.0),
                             logprob_threshold: float = -1.0,
                             compression_ratio_threshold: float = 2.4,
                             seed: int = 0):
    """Whisper's temperature-fallback decode: start greedy; rows whose
    average logprob falls below `logprob_threshold`, or whose decoded text
    zlib-compresses too well (ratio >= `compression_ratio_threshold`), are
    decoded again at the next temperature.

    `asr_apply(mel, max_tokens, temperature, generator) -> (tokens [B, T],
    avg_logprob [B])`, e.g. a WhisperForASR call; rung i draws from
    `torch.Generator(device).manual_seed(seed + i)` on the device of `mel`
    (the CPU for a numpy `mel`).  Returns numpy (tokens [B, T],
    avg_logprob [B], temperature used [B])."""
    b = mel.shape[0]
    dev = mel.device if isinstance(mel, torch.Tensor) else torch.device("cpu")
    out_tokens = out_lp = None
    out_temp = np.zeros((b,), np.float32)
    remaining = np.ones((b,), bool)
    for ti, temp in enumerate(temperatures):
        tokens, avg_lp = asr_apply(mel, max_tokens, float(temp),
                                   torch.Generator(dev).manual_seed(seed + ti))
        tokens, avg_lp = _numpy(tokens), _numpy(avg_lp)
        if out_tokens is None:
            out_tokens, out_lp = tokens.copy(), avg_lp.copy()
            out_temp[:] = temp
        else:
            out_tokens[remaining] = tokens[remaining]
            out_lp[remaining] = avg_lp[remaining]
            out_temp[remaining] = temp
        ok = out_lp > logprob_threshold
        if tokenizer is not None:
            for i in np.flatnonzero(remaining):
                text = tokenizer.decode(
                    [int(t) for t in out_tokens[i]], skip_special_tokens=True)
                raw = text.encode("utf-8")
                if raw:
                    ratio = len(raw) / max(len(zlib.compress(raw)), 1)
                    ok[i] = ok[i] and ratio < compression_ratio_threshold
        remaining = remaining & ~ok
        if not remaining.any():
            break
    return out_tokens, out_lp, out_temp


def _numpy(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def split_words(text: str) -> List[str]:
    """' '-prefixed whitespace words."""
    return [" " + w for w in re.split(r"\s", text.strip()) if w]


def dual_tokenize(words: Sequence[str], asr_tokenizer, llm_tokenizer
                  ) -> Dict[str, np.ndarray]:
    asr_ids, asr_words, llm_ids, llm_words = [], [], [], []
    for i, word in enumerate(words):
        for tid in asr_tokenizer.encode(word, add_special_tokens=False):
            asr_ids.append(tid)
            asr_words.append(i)
        for tid in llm_tokenizer.encode(word, add_special_tokens=False):
            llm_ids.append(tid)
            llm_words.append(i)
    return {
        "asr_token_ids": np.asarray([asr_ids], np.int32),
        "asr_token_lengths": np.asarray([len(asr_ids)], np.int32),
        "asr_word_ids": np.asarray([asr_words], np.int32),
        "llm_token_ids": np.asarray([llm_ids], np.int32),
        "llm_token_lengths": np.asarray([len(llm_ids)], np.int32),
        "llm_word_ids": np.asarray([llm_words], np.int32),
    }


@dataclass
class TasteProcessor:
    """Pluggable hooks:
      asr_tokenizer / llm_tokenizer: HF-style .encode
      speaker_embedder(fbank80 [B, T, 80]) -> [192] x-vector (CAM++)
      s3_tokenizer(mel128 [1, 128, 3000], n_valid_frames) -> [T] int ids
      transcriber(wav16k [T]) -> str (whisper ASR)
    The signal processing runs on `device` (None: CUDA, which must be
    present; "cpu" for the plain CPU run)."""

    asr_tokenizer: Any = None
    llm_tokenizer: Any = None
    speaker_embedder: Optional[Callable] = None
    s3_tokenizer: Optional[Callable] = None
    transcriber: Optional[Callable] = None
    frontend: AudioFrontendConfig = field(default_factory=AudioFrontendConfig)
    device: Optional[Union[str, torch.device]] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, np.float32)).to(self.device)

    def process_text(self, text: Optional[str] = None,
                     words: Optional[Sequence[str]] = None
                     ) -> Dict[str, np.ndarray]:
        if words is None:
            words = split_words(re.sub(r"\s", " ", text))
        return dual_tokenize(words, self.asr_tokenizer, self.llm_tokenizer)

    def speaker_embedding(self, ref_audio_list: Sequence[np.ndarray]
                          ) -> np.ndarray:
        """The x-vectors of the reference clips, averaged and
        L2-normalized."""
        embs = []
        for wav in ref_audio_list:
            feats = A.speaker_fbank_features(self._tensor(wav)[None])
            embs.append(np.asarray(self.speaker_embedder(
                feats.cpu().numpy())).reshape(-1))
        emb = np.mean(np.stack(embs), axis=0)
        return emb / max(np.linalg.norm(emb), 1e-8)

    @torch.no_grad()
    def __call__(self, audio: np.ndarray, sampling_rate: int,
                 text: Optional[str] = None,
                 ref_audio_list: Optional[Sequence[np.ndarray]] = None
                 ) -> Dict[str, np.ndarray]:
        if audio.ndim != 1:
            raise ValueError(f"audio must be 1-D, got shape {audio.shape}")
        wav = self._tensor(audio)
        if sampling_rate != self.frontend.sample_rate:
            wav = A.resample(wav[None], sampling_rate,
                             self.frontend.sample_rate)[0]
            audio = wav.cpu().numpy()
        data: Dict[str, np.ndarray] = {}

        if ref_audio_list is not None and self.speaker_embedder is not None:
            data["speaker_embeds"] = self.speaker_embedding(ref_audio_list)[None]

        mel = A.whisper_log_mel(wav[None], n_mels=self.frontend.n_mels)
        data["audio_features"] = mel.cpu().numpy()
        data["audio_feature_lengths"] = np.asarray(
            [len(audio) // self.frontend.hop_length], np.int32)

        if self.s3_tokenizer is not None:
            s3 = np.asarray(self.s3_tokenizer(
                data["audio_features"], data["audio_feature_lengths"][0]),
                np.int32).reshape(-1)
            data["speech_token_ids"] = s3[None]
            data["speech_token_lengths"] = np.asarray([len(s3)], np.int32)

        if text is None:
            if self.transcriber is None:
                raise ValueError("`text` is needed (no transcriber hook)")
            text = self.transcriber(audio)
        data.update(self.process_text(text=text))
        return data
