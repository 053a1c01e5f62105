"""Stage-2 data prep: the llm-aligned taste indices of a dataset
(counterpart of the JAX repo's scripts/extract_vq.py).

    python -m taste_spokenlm_tpu_torch.scripts.extract_vq \\
        --seed-model ./seed --synthetic --num-batches 2 --output ./vq_out

Batched TasteForCausalLM.extract_vq over --synthetic batches (random
inputs from RandomState(0), JAX's shapes) or one epoch of the stage-1
arrow shards (--data with --asr-tokenizer / --llm-tokenizer: HF tokenizer
dirs or "offline"), one JSON row per utterance in
<output>/part-0.jsonl: asr_indices, and llm_indices / llm_token_ids /
llm_word_ids cut to the utterance's llm length.  Runs on --device (default
CUDA; --device cpu or --platform cpu).
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Iterator

import numpy as np
import torch

from taste_spokenlm_tpu_torch.scripts import _cli

INPUTS = ("asr_token_ids", "asr_token_lengths", "asr_word_ids",
          "llm_token_ids", "llm_token_lengths", "llm_word_ids",
          "audio_features")


def synthetic_batches(cfg, num_batches: int, batch_size: int,
                      seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """JAX's synthetic extract_vq batches: 8 asr and 8 llm tokens, two a
    word, and a random mel of the tower's window."""
    rng = np.random.RandomState(seed)
    t_tok, b = 8, batch_size
    w = cfg.audio_tower.whisper
    words = np.tile((np.arange(t_tok) // 2)[None], (b, 1)).astype("i4")
    for _ in range(num_batches):
        yield {
            "asr_token_ids": rng.randint(5, w.vocab_size, (b, t_tok)).astype("i4"),
            "asr_token_lengths": np.full((b,), t_tok, "i4"),
            "asr_word_ids": words,
            "llm_token_ids": rng.randint(
                2, cfg.spoken_lm.llama.vocab_size, (b, t_tok)).astype("i4"),
            "llm_token_lengths": np.full((b,), t_tok, "i4"),
            "llm_word_ids": words,
            "audio_features": rng.randn(b, w.n_mels, w.max_source_positions * 2
                                        ).astype("f4"),
        }


def main(argv=None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed-model", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--num-batches", type=int, default=2)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--data", nargs="*", default=[],
                   help="stage-1 arrow shard files (globs ok)")
    p.add_argument("--asr-tokenizer", default=None)
    p.add_argument("--llm-tokenizer", default=None)
    p.add_argument("--token-budget", type=int, default=2048)
    _cli.add_device_flags(p)
    args = p.parse_args(argv)

    from taste_spokenlm_tpu_torch.pretrained import from_pretrained
    dev = _cli.device_from(args)
    model, _ = from_pretrained(args.seed_model, device=dev)
    cfg = model.config
    batches = (synthetic_batches(cfg, args.num_batches, args.batch_size)
               if args.synthetic else _cli.stage1_batches(args, cfg))

    os.makedirs(args.output, exist_ok=True)
    rows = []
    with torch.no_grad():
        for batch in batches:
            x = _cli.to_device(batch, dev, INPUTS)
            asr_idx, llm_idx = model.extract_vq(*(x[k] for k in INPUTS))
            asr_idx, llm_idx = asr_idx.cpu().numpy(), llm_idx.cpu().numpy()
            lens = np.asarray(batch["llm_token_lengths"])
            ids = np.asarray(batch["llm_token_ids"])
            words = np.asarray(batch["llm_word_ids"])
            for bi in range(ids.shape[0]):
                n = int(lens[bi])
                rows.append({
                    "asr_indices": asr_idx[bi].tolist(),
                    "llm_indices": llm_idx[bi, :n].tolist(),
                    "llm_token_ids": ids[bi, :n].tolist(),
                    "llm_word_ids": words[bi, :n].tolist(),
                })
    shard = os.path.join(args.output, "part-0.jsonl")
    with open(shard, "w") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")
    print(f"wrote {len(rows)} rows to {shard}", flush=True)
    return {"rows": len(rows), "path": shard}


if __name__ == "__main__":
    main()
