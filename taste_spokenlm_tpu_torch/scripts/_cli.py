"""What the offline CLIs (generate_audio, extract_vq, eval) share: the
device flags, the tokenizers, the stage-1 data stream and the synthetic
batches."""

from __future__ import annotations

import argparse
import glob
import itertools
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch


def add_device_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu, the plain versions")
    p.add_argument("--platform", default=None,
                   help="JAX's flag: 'cpu' means --device cpu")


def device_from(args) -> torch.device:
    """--device, else --platform cpu, else CUDA (which must be present).
    TF32 is turned off for the process: f32 stays f32 on the card, as the
    tower's RVQ and the S3 graph's VQ need (their argmins flip on TF32
    drift; cuDNN's convolutions would take TF32 by default)."""
    from taste_spokenlm_tpu_torch.device import resolve_device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return resolve_device(args.device or (
        "cpu" if args.platform == "cpu" else None))


class OfflineTokenizer:
    """A deterministic stand-in tokenizer for runs without tokenizer files
    (`--asr-tokenizer offline` / `--llm-tokenizer offline`): each
    whitespace word of a text is one id, from its characters; an id
    decodes to one of a few fixed pieces (as bench.py's vocabulary scan),
    so the sampler's tables mark word starts, sentence ends and banned ids
    as a real vocabulary does.  It has no special tokens and no chat
    template."""

    PIECES = (" the", "ing", ".", " end.", "!!", "a\nb", " word", "s", ",'",
              " no.", "xyz")
    bos_token_id = eos_token_id = None

    def __init__(self, vocab_size: int, first_id: int = 2):
        self.vocab_size = vocab_size
        self.first_id = first_id

    def __len__(self) -> int:
        return self.vocab_size

    def encode(self, text: str, add_special_tokens: bool = False) -> list:
        span = self.vocab_size - self.first_id
        return [self.first_id + sum(map(ord, w)) % span for w in text.split()]

    def decode(self, ids, skip_special_tokens: bool = False) -> str:
        if isinstance(ids, (int, np.integer)):
            return self.PIECES[int(ids) % len(self.PIECES)]
        return "".join(self.PIECES[int(i) % len(self.PIECES)] for i in ids)


def load_tokenizers(asr: Optional[str], llm: Optional[str], cfg
                    ) -> Tuple[Any, Any]:
    """(asr tokenizer, llm tokenizer): HF tokenizer dirs (transformers is
    imported only then) or "offline"; one given stands for both, as in
    JAX's CLI; (None, None) when neither is."""
    if not (asr or llm):
        return None, None
    asr, llm = asr or llm, llm or asr

    def load(name, vocab, first_id):
        if name == "offline":
            return OfflineTokenizer(vocab, first_id)
        from transformers import AutoTokenizer
        return AutoTokenizer.from_pretrained(name)
    return (load(asr, cfg.audio_tower.whisper.vocab_size, 10),
            load(llm, cfg.spoken_lm.llama.vocab_size, 2))


def stage1_batches(args, cfg, seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """One epoch of bucketed stage-1 batches from --data (arrow shards,
    globs allowed), tokenized by --asr-tokenizer / --llm-tokenizer, as the
    train CLI's pipeline makes them; --num-batches 0 takes them all."""
    from taste_spokenlm_tpu_torch.data.dataset import Stage1Dataset
    from taste_spokenlm_tpu_torch.frontend.processor import TasteProcessor
    if not (args.data and args.asr_tokenizer and args.llm_tokenizer):
        raise SystemExit("--data/--asr-tokenizer/--llm-tokenizer are "
                         "required without --synthetic")
    files = [f for pat in args.data for f in (sorted(glob.glob(pat)) or [pat])]
    asr_tok, llm_tok = load_tokenizers(args.asr_tokenizer, args.llm_tokenizer,
                                       cfg)
    proc = TasteProcessor(asr_tokenizer=asr_tok, llm_tokenizer=llm_tok,
                          device="cpu")
    w = cfg.audio_tower.whisper
    ds = Stage1Dataset(files, tokenize_fn=lambda text: proc.process_text(
        text=text), seed=seed, token_budget=args.token_budget,
        n_mels=w.n_mels, mel_frames=2 * w.max_source_positions)
    yield from itertools.islice(ds.batches(epoch=0), args.num_batches or None)


def to_device(batch: Dict[str, np.ndarray], dev: torch.device,
              keys=None) -> Dict[str, torch.Tensor]:
    """numpy batch -> tensors on `dev`: floats f32, integers int64."""
    out = {}
    for k, v in batch.items():
        if keys is not None and k not in keys:
            continue
        a = np.asarray(v)
        t = torch.from_numpy(np.ascontiguousarray(a))
        out[k] = (t.float() if np.issubdtype(a.dtype, np.floating)
                  else t.long()).to(dev)
    return out
