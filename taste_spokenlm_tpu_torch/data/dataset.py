"""The training data pipeline (counterpart of the JAX data/dataset.py):
TASTE-Dump arrow shards and stage-2 jsonl shards -> fixed-shape batches.

numpy in, numpy out, the same arrays as JAX's for the same examples:

* deterministic per-host shard assignment (`shard_files`: shard k to host
  k % hosts; a host is a process of the data-parallel group);
* examples routed to the smallest static bucket that fits
  (`pick_bucket`, `BucketBatcher`), so every batch has one of a few shapes;
* `collate` pads a bucket's examples to its shape;
* the audio preprocessing (the 16 kHz resample, the whisper log-mel, the
  flow's 22.05 kHz mel) runs through the port's ops/audio.py on the host.

`datasets` is imported lazily, when an arrow shard is read.
"""

from __future__ import annotations

import dataclasses
import subprocess
from typing import Any, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from taste_spokenlm_tpu_torch.ops import audio as audio_ops

REQUIRED_COLUMNS = (
    "speaker_embeds",
    "asr_token_ids", "asr_token_lengths", "asr_word_ids",
    "llm_token_ids", "llm_token_lengths", "llm_word_ids",
    "audio_features", "audio_feature_lengths",
    "speech_token_ids", "speech_token_lengths",
)


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    """Static bucket shapes: (max asr tokens, max llm tokens, max speech
    tokens).  Audio features are always the fixed whisper 30 s window."""

    asr_tokens: int
    llm_tokens: int
    speech_tokens: int


DEFAULT_BUCKETS = (
    BucketSpec(32, 48, 256),
    BucketSpec(64, 96, 512),
    BucketSpec(96, 144, 768),
    BucketSpec(128, 192, 1024),
)


def shard_files(files: Sequence[str], host_index: int, host_count: int
                ) -> List[str]:
    """Deterministic per-host shard assignment."""
    return [f for i, f in enumerate(sorted(files))
            if i % host_count == host_index]


def pick_bucket(example: Dict[str, Any],
                buckets: Sequence[BucketSpec]) -> Optional[int]:
    na = len(example["asr_token_ids"])
    nl = len(example["llm_token_ids"])
    ns = len(example["speech_token_ids"])
    for i, b in enumerate(buckets):
        if na <= b.asr_tokens and nl <= b.llm_tokens and ns <= b.speech_tokens:
            return i
    return None  # too long -> dropped (reference length filter)


def _pad_to(x: np.ndarray, n: int, value=0) -> np.ndarray:
    pad = [(0, n - x.shape[0])] + [(0, 0)] * (x.ndim - 1)
    return np.pad(np.asarray(x), pad, constant_values=value)


def collate(examples: List[Dict[str, Any]], bucket: BucketSpec,
            n_mels: int = 128, mel_frames: int = 3000) -> Dict[str, np.ndarray]:
    """Pad a bucket's examples to its static shape
    (pad_seq_collate_fn equivalent, dataset.py:154-172)."""
    b = len(examples)
    out: Dict[str, np.ndarray] = {}
    out["speaker_embeds"] = np.stack(
        [np.asarray(e["speaker_embeds"], np.float32) for e in examples])
    for key, n in (("asr_token_ids", bucket.asr_tokens),
                   ("asr_word_ids", bucket.asr_tokens),
                   ("llm_token_ids", bucket.llm_tokens),
                   ("llm_word_ids", bucket.llm_tokens),
                   ("speech_token_ids", bucket.speech_tokens)):
        out[key] = np.stack([
            _pad_to(np.asarray(e[key], np.int32), n) for e in examples])
    for key, src in (("asr_token_lengths", "asr_token_ids"),
                     ("llm_token_lengths", "llm_token_ids"),
                     ("speech_token_lengths", "speech_token_ids")):
        out[key] = np.asarray([len(e[src]) for e in examples], np.int32)
    feats = []
    feat_lens = []
    if examples and "audio_samples" in examples[0]:
        # mel_on_device stream: raw 16 kHz samples padded to the mel window
        # (the whisper_log_mel runs IN-GRAPH on the accelerator — the host
        # pipeline stays IO + tokenize + collate only)
        n_samp = mel_frames * 160
        for e in examples:
            w = np.asarray(e["audio_samples"], np.float32)[:n_samp]
            feats.append(_pad_to(w, n_samp))
            feat_lens.append(int(e["audio_feature_lengths"]))
        out["audio_samples"] = np.stack(feats)
        out["audio_feature_lengths"] = np.asarray(feat_lens, np.int32)
        return out
    for e in examples:
        f = np.asarray(e["audio_features"], np.float32)
        if f.shape[-1] < mel_frames:
            f = np.pad(f, ((0, 0), (0, mel_frames - f.shape[-1])))
        feats.append(f[:, :mel_frames])
        feat_lens.append(int(e.get("audio_feature_lengths", f.shape[-1])))
    out["audio_features"] = np.stack(feats)
    out["audio_feature_lengths"] = np.asarray(feat_lens, np.int32)
    return out


class BucketBatcher:
    """Route examples to static buckets; emit a batch when a bucket fills.

    Batch size per bucket is chosen so every batch carries a similar token
    budget (the fixed-shape replacement for
    dynamic_batch(max_frames_in_batch), processor.py:449-477)."""

    def __init__(self, buckets: Sequence[BucketSpec] = DEFAULT_BUCKETS,
                 token_budget: int = 2048, min_batch: int = 1,
                 drop_overlong: bool = True):
        self.buckets = tuple(buckets)
        self.batch_sizes = [max(min_batch, token_budget // b.speech_tokens)
                            for b in self.buckets]
        self.pending: List[List[Dict]] = [[] for _ in self.buckets]
        self.drop_overlong = drop_overlong
        self.n_dropped = 0

    def __call__(self, examples: Iterable[Dict[str, Any]]
                 ) -> Iterator[Tuple[BucketSpec, List[Dict]]]:
        for ex in examples:
            i = pick_bucket(ex, self.buckets)
            if i is None:
                self.n_dropped += 1
                continue
            self.pending[i].append(ex)
            if len(self.pending[i]) >= self.batch_sizes[i]:
                yield self.buckets[i], self.pending[i]
                self.pending[i] = []

    def flush(self) -> Iterator[Tuple[BucketSpec, List[Dict]]]:
        for i, pend in enumerate(self.pending):
            if pend:
                yield self.buckets[i], pend
                self.pending[i] = []


class Stage1Dataset:
    """Streams (bucket, batch-dict) pairs from TASTE-Dump-style arrow shards.

    Each raw example provides: mp3 (array + sampling_rate), json.text,
    s3_token, spk_emb (dataset.py:37-80).  Tokenization callbacks are
    injected (whisper/llama tokenizers with shared word ids,
    processing_taste.py:173-206).

    `mel_on_device=True` emits the raw 16 kHz samples as "audio_samples"
    (padded to the mel window by collate) in place of the log-mel, as
    JAX's does.  JAX's note names the step that would take them,
    train_step.with_on_device_mel; neither package has it, so no step of
    either consumes "audio_samples".
    """

    def __init__(self, files: Sequence[str], tokenize_fn,
                 host_index: int = 0, host_count: int = 1,
                 seed: int = 0, buckets=DEFAULT_BUCKETS,
                 token_budget: int = 2048,
                 n_mels: int = 128, mel_frames: int = 3000,
                 mel_on_device: bool = False):
        # n_mels/mel_frames default to the whisper-large 30 s window; pass
        # the model's (whisper.n_mels, 2*whisper.max_source_positions) so
        # smaller configs (e.g. TasteConfig.tiny) can train on real shards.
        self.files = shard_files(files, host_index, host_count)
        self.tokenize_fn = tokenize_fn
        self.seed = seed
        self.batcher = BucketBatcher(buckets, token_budget)
        self.n_mels = n_mels
        self.mel_frames = mel_frames
        self.mel_on_device = mel_on_device

    def _iter_raw(self, epoch: int) -> Iterator[Dict]:
        import datasets  # lazy: offline unit tests use synthetic examples
        rng = np.random.RandomState(self.seed + epoch)
        files = list(self.files)
        rng.shuffle(files)
        for f in files:
            # numpy formatting: without it `ds[i]` converts every audio
            # array through a PYTHON LIST (~1 s per 30 s utterance — the
            # measured host pipeline was 24x too slow for the chip);
            # with it the arrow buffer is sliced zero-copy
            ds = datasets.Dataset.from_file(f).with_format("numpy")
            order = rng.permutation(len(ds))
            for i in order:
                yield ds[int(i)]

    def _resample16(self, wav: np.ndarray, sr: int) -> np.ndarray:
        if sr == 16000:
            return wav
        if self.mel_on_device:
            # host-light path: the native C++ resampler (data/native.py; no
            # torch dispatch, so the prefetch thread does not contend with
            # the train step), the torch one where it cannot build
            try:
                from taste_spokenlm_tpu_torch.data import native
                return native.resample(wav, sr, 16000)
            except (OSError, RuntimeError, subprocess.CalledProcessError):
                pass
        return audio_ops.resample(torch.from_numpy(np.array(wav[None])), sr,
                                  16000)[0].numpy()

    def _prepare(self, raw: Dict) -> Optional[Dict]:
        wav = np.asarray(raw["mp3"]["array"], np.float32)
        sr = int(raw["mp3"]["sampling_rate"])
        if wav.ndim > 1:
            wav = wav.mean(0)
        wav16 = self._resample16(wav, sr)
        tok = self.tokenize_fn(raw["json"]["text"])
        if tok is None:
            return None
        # accept either flat [T] arrays or the processor's batched [1, T];
        # drop *_lengths (collate re-derives them from the flat arrays)
        tok = {k: (np.asarray(v)[0] if np.asarray(v).ndim > 1 else np.asarray(v))
               for k, v in tok.items() if not k.endswith("lengths")}
        ex = {
            "speaker_embeds": np.asarray(raw["spk_emb"], np.float32),
            "audio_feature_lengths": min(len(wav16) // 160, self.mel_frames),
            "speech_token_ids": np.asarray(raw["s3_token"], np.int32),
            **tok,
        }
        if self.mel_on_device:
            ex["audio_samples"] = wav16
            return ex
        ex["audio_features"] = audio_ops.whisper_log_mel(
            torch.from_numpy(np.array(wav16[None])), n_mels=self.n_mels,
            n_samples=self.mel_frames * 160)[0].numpy()
        return ex

    def batches(self, epoch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        def gen():
            for raw in self._iter_raw(epoch):
                ex = self._prepare(raw)
                if ex is not None:
                    yield ex
        for bucket, group in self.batcher(gen()):
            yield collate(group, bucket, self.n_mels, self.mel_frames)
        # epoch tail: emit partially-filled buckets instead of dropping them
        for bucket, group in self.batcher.flush():
            yield collate(group, bucket, self.n_mels, self.mel_frames)


class FlowDataset:
    """Flow-matching training stream: TASTE-Dump arrow shards ->
    (S3 tokens, 22.05 kHz CosyVoice mel targets, x-vector) batches.

    The reference trains flow through the hyperpyyaml data chain
    (cosyvoice/dataset/processor.py compute_fbank with
    matcha.utils.audio.mel_spectrogram + parse_embedding(normalize=True),
    dynamic max_frames_in_batch batching); here the mel comes from the
    port's ops/audio.flow_mel and batches land in static (token, frame)
    buckets.
    """

    def __init__(self, files: Sequence[str], host_index: int = 0,
                 host_count: int = 1, seed: int = 0,
                 token_buckets: Sequence[int] = (64, 128, 256),
                 token_budget: int = 2048, n_mels: int = 80,
                 sample_rate: int = 22050, hop: int = 256,
                 token_frame_rate: int = 25):
        self.files = shard_files(files, host_index, host_count)
        self.seed = seed
        self.token_buckets = tuple(sorted(token_buckets))
        # mel frames per token: (1/token_rate) s * sample_rate / hop
        fpt = sample_rate / (hop * token_frame_rate)
        self.frame_buckets = [int(np.ceil(t * fpt)) for t in self.token_buckets]
        self.batch_sizes = [max(1, token_budget // t)
                            for t in self.token_buckets]
        self.n_mels = n_mels
        self.sample_rate = sample_rate
        self.hop = hop
        self.n_dropped = 0

    def _iter_raw(self, epoch: int) -> Iterator[Dict]:
        import datasets
        rng = np.random.RandomState(self.seed + epoch)
        files = list(self.files)
        rng.shuffle(files)
        for f in files:
            # zero-copy numpy reads (see Stage1Dataset._iter_raw)
            ds = datasets.Dataset.from_file(f).with_format("numpy")
            for i in rng.permutation(len(ds)):
                yield ds[int(i)]

    def _prepare(self, raw: Dict) -> Dict:
        wav = np.asarray(raw["mp3"]["array"], np.float32)
        sr = int(raw["mp3"]["sampling_rate"])
        if wav.ndim > 1:
            wav = wav.mean(0)
        wav22 = audio_ops.resample(torch.from_numpy(np.array(wav[None])), sr,
                                   self.sample_rate)
        feat = audio_ops.flow_mel(wav22, sr=self.sample_rate, hop=self.hop,
                                  n_mels=self.n_mels)[0].numpy()
        emb = np.asarray(raw["spk_emb"], np.float32)
        emb = emb / max(np.linalg.norm(emb), 1e-8)  # parse_embedding
        return {
            "speech_token_ids": np.asarray(raw["s3_token"], np.int32),
            "feat": feat,
            "embedding": emb,
        }

    def _collate(self, rows: List[Dict], slot: int) -> Dict[str, np.ndarray]:
        nt, nf = self.token_buckets[slot], self.frame_buckets[slot]
        feats, feat_lens = [], []
        for r in rows:
            f = r["feat"][:nf]
            feat_lens.append(f.shape[0])
            feats.append(np.pad(f, ((0, nf - f.shape[0]), (0, 0))))
        return {
            "speech_token_ids": np.stack([
                _pad_to(r["speech_token_ids"][:nt], nt) for r in rows]),
            "speech_token_lengths": np.asarray(
                [min(len(r["speech_token_ids"]), nt) for r in rows], np.int32),
            "feat": np.stack(feats).astype(np.float32),
            "feat_lengths": np.asarray(feat_lens, np.int32),
            "embedding": np.stack([r["embedding"] for r in rows]),
        }

    def batches(self, epoch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        pending: List[List[Dict]] = [[] for _ in self.token_buckets]
        for raw in self._iter_raw(epoch):
            ex = self._prepare(raw)
            t = len(ex["speech_token_ids"])
            slot = next((i for i, n in enumerate(self.token_buckets)
                         if t <= n), None)
            if slot is None:
                self.n_dropped += 1
                continue
            pending[slot].append(ex)
            if len(pending[slot]) >= self.batch_sizes[slot]:
                yield self._collate(pending[slot], slot)
                pending[slot] = []
        for slot, group in enumerate(pending):
            if group:
                yield self._collate(group, slot)


class Stage2JsonlDataset:
    """Streams stage-2 SLM batches from the VQ-extraction jsonl shards
    (scripts/extract_vq.py output; the reference equivalent is the HF
    dataset written by extract_vq_for_stage2_training.py:17-185).

    Row schema: {"llm_indices": [T, L], "llm_token_ids": [T],
    "llm_word_ids": [T]}.  Rows are bucketed by llm length to static shapes;
    llm_indices pad with IGNORE (-1) so the delay machinery treats padding
    as no-taste positions.
    """

    def __init__(self, files: Sequence[str], host_index: int = 0,
                 host_count: int = 1, seed: int = 0,
                 llm_buckets: Sequence[int] = (48, 96, 144, 192),
                 token_budget: int = 2048):
        self.files = shard_files(files, host_index, host_count)
        self.seed = seed
        self.llm_buckets = tuple(sorted(llm_buckets))
        self.batch_sizes = [max(1, token_budget // n)
                            for n in self.llm_buckets]
        self.n_dropped = 0

    def _iter_rows(self, epoch: int) -> Iterator[Dict]:
        import json
        rng = np.random.RandomState(self.seed + epoch)
        files = list(self.files)
        rng.shuffle(files)
        for f in files:
            with open(f) as fh:
                rows = [json.loads(line) for line in fh if line.strip()]
            for i in rng.permutation(len(rows)):
                yield rows[int(i)]

    def batches(self, epoch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        pending: List[List[Dict]] = [[] for _ in self.llm_buckets]
        for row in self._iter_rows(epoch):
            t = len(row["llm_token_ids"])
            slot = next((i for i, n in enumerate(self.llm_buckets) if t <= n),
                        None)
            if slot is None:
                self.n_dropped += 1
                continue
            pending[slot].append(row)
            if len(pending[slot]) >= self.batch_sizes[slot]:
                yield self._collate(pending[slot], self.llm_buckets[slot])
                pending[slot] = []
        for slot, group in enumerate(pending):
            if group:
                yield self._collate(group, self.llm_buckets[slot])

    @staticmethod
    def _collate(rows: List[Dict], n: int) -> Dict[str, np.ndarray]:
        out = {
            "llm_token_ids": np.stack([
                _pad_to(np.asarray(r["llm_token_ids"], np.int32), n)
                for r in rows]),
            "llm_word_ids": np.stack([
                _pad_to(np.asarray(r["llm_word_ids"], np.int32), n)
                for r in rows]),
            "llm_token_lengths": np.asarray(
                [len(r["llm_token_ids"]) for r in rows], np.int32),
            "llm_indices": np.stack([
                _pad_to(np.asarray(r["llm_indices"], np.int32), n, value=-1)
                for r in rows]),
        }
        return out
