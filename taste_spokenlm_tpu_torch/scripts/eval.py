"""Evaluation CLI: teacher-forced accuracy and losses of both stages
(counterpart of the JAX repo's scripts/eval.py).

    python -m taste_spokenlm_tpu_torch.scripts.eval --seed-model ./seed \\
        --synthetic --output eval.json

Per batch, stage 1 (forward_speech_autoencoder: loss and
speech_token_accuracy) and stage 2 (extract_vq, then forward_spoken_llm:
eval_metrics_stage2 and the selection protocol's loglikelihood /
reversed_loglikelihood); the metrics averaged over the batches, rounded to
5 decimals as JAX's CLI writes them, into --output.  Batches are
--synthetic (JAX's shapes, from RandomState(--seed)) or one epoch of the
stage-1 arrow shards (--data with --asr-tokenizer / --llm-tokenizer).
--selection-data scores real against distractor continuations (a jsonl
of {prefix, real, distractor} llm ids): choose-the-real accuracy.  Runs on
--device (default CUDA; --device cpu or --platform cpu).
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, Iterator

import numpy as np
import torch

from taste_spokenlm_tpu_torch.scripts import _cli

T_TOK, T_SP = 8, 12


def synthetic_batches(cfg, num_batches: int, batch_size: int, seed: int
                      ) -> Iterator[Dict[str, np.ndarray]]:
    """JAX's synthetic eval batches (8 asr / llm tokens, 12 S3 tokens),
    drawn in its order from RandomState(seed)."""
    rng = np.random.RandomState(seed)
    b, w = batch_size, cfg.audio_tower.whisper
    words = np.tile((np.arange(T_TOK) // 2)[None], (b, 1))
    for _ in range(num_batches):
        yield {
            "speaker_embeds": rng.randn(
                b, cfg.speech_decoder.spk_embed_dim).astype(np.float32),
            "asr_token_ids": rng.randint(5, w.vocab_size, (b, T_TOK)),
            "asr_token_lengths": np.full((b,), T_TOK, np.int32),
            "asr_word_ids": words,
            "audio_features": rng.randn(b, w.n_mels, w.max_source_positions * 2
                                        ).astype(np.float32),
            "speech_token_ids": rng.randint(
                0, cfg.speech_decoder.speech_token_size, (b, T_SP)),
            "speech_token_lengths": np.full((b,), T_SP, np.int32),
            "llm_token_ids": rng.randint(2, cfg.spoken_lm.llama.vocab_size,
                                         (b, T_TOK)),
            "llm_token_lengths": np.full((b,), T_TOK, np.int32),
            "llm_word_ids": words,
        }


@torch.no_grad()
def eval_stage1(model, x) -> Dict[str, torch.Tensor]:
    out = model.forward_speech_autoencoder(
        x["speaker_embeds"], x["asr_token_ids"], x["asr_token_lengths"],
        x["asr_word_ids"], x["audio_features"], x["speech_token_ids"],
        x["speech_token_lengths"])
    return {"speech_token_accuracy": out["speech_token_accuracy"],
            "loss": out["loss"]}


@torch.no_grad()
def eval_stage2(model, x) -> Dict[str, torch.Tensor]:
    from taste_spokenlm_tpu_torch.ops.losses import masked_log_likelihood
    from taste_spokenlm_tpu_torch.train.train_step import eval_metrics_stage2
    _, llm_idx = model.extract_vq(
        x["asr_token_ids"], x["asr_token_lengths"], x["asr_word_ids"],
        x["llm_token_ids"], x["llm_token_lengths"], x["llm_word_ids"],
        x["audio_features"])
    out = model.forward_spoken_llm(llm_idx, x["llm_token_ids"],
                                   x["llm_token_lengths"], x["llm_word_ids"])
    m = eval_metrics_stage2(out, model.config.audio_tower.quantizer.num_quantizers)
    m["loglikelihood"], m["reversed_loglikelihood"] = masked_log_likelihood(
        out["text_logits"], out["text_labels"])
    return m


@torch.no_grad()
def selection_eval(model, path: str) -> Dict:
    """Per pair: the mean log p of each continuation token (an empty taste
    channel) for the real and the distractor continuation; accuracy = the
    share of pairs where the real one scores higher."""
    cfg, dev = model.config, model.device
    with open(path) as f:
        pairs = [json.loads(line) for line in f if line.strip()]
    n_levels, slot = cfg.audio_tower.quantizer.num_quantizers, 16
    lens = [len(q["prefix"]) + max(len(q["real"]), len(q["distractor"]))
            for q in pairs]
    t = -(-max(lens) // slot) * slot     # one bucket for all pairs

    def cont_ll(prefix, cont):
        ids = np.zeros((t,), np.int64)
        seq = (prefix + cont)[:t]
        ids[:len(seq)] = seq
        out = model.forward_spoken_llm(
            torch.full((1, t, n_levels), -1, dtype=torch.long, device=dev),
            torch.from_numpy(ids)[None].to(dev),
            torch.tensor([len(seq)], device=dev),
            torch.arange(t, device=dev)[None])
        logits = out["text_logits"].float()[0].cpu().numpy()
        labels = out["text_labels"][0].cpu().numpy()
        lse = logits.max(-1) + np.log(
            np.exp(logits - logits.max(-1, keepdims=True)).sum(-1))
        valid = np.flatnonzero(labels != -1)
        keep = valid[-min(len(cont), len(valid)):]   # the continuation's
        return float((logits[keep, labels[keep]] - lse[keep]).mean())

    n_correct, ll_r, ll_d = 0, [], []
    for q in pairs:
        a, b = cont_ll(q["prefix"], q["real"]), cont_ll(q["prefix"],
                                                        q["distractor"])
        n_correct += a > b
        ll_r.append(a)
        ll_d.append(b)
    return {"selection_accuracy": round(n_correct / max(len(pairs), 1), 5),
            "selection_pairs": len(pairs),
            "selection_ll_real": round(float(np.mean(ll_r)), 5),
            "selection_ll_distractor": round(float(np.mean(ll_d)), 5)}


def main(argv=None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed-model", required=True)
    p.add_argument("--output", default="eval.json")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--num-batches", type=int, default=2)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--data", nargs="*", default=[],
                   help="stage-1 arrow shard files (globs ok)")
    p.add_argument("--asr-tokenizer", default=None)
    p.add_argument("--llm-tokenizer", default=None)
    p.add_argument("--token-budget", type=int, default=2048)
    p.add_argument("--selection-data", default=None,
                   help="selection-pair jsonl: score real against distractor "
                        "continuations with the spoken LM")
    _cli.add_device_flags(p)
    args = p.parse_args(argv)

    from taste_spokenlm_tpu_torch.pretrained import from_pretrained
    dev = _cli.device_from(args)
    model, _ = from_pretrained(args.seed_model, device=dev)
    cfg = model.config
    batches = (synthetic_batches(cfg, args.num_batches, args.batch_size,
                                 args.seed)
               if args.synthetic else _cli.stage1_batches(args, cfg, args.seed))
    sums: Dict[str, float] = {}
    n = 0
    for batch in batches:
        x = _cli.to_device(batch, dev)
        for fn in (eval_stage1, eval_stage2):
            for k, v in fn(model, x).items():
                sums[k] = sums.get(k, 0.0) + float(v)
        n += 1
    metrics = {k: round(v / n, 5) for k, v in sums.items()}
    if args.selection_data:
        metrics.update(selection_eval(model, args.selection_data))
    with open(args.output, "w") as f:
        json.dump(metrics, f, indent=2)
    print(json.dumps(metrics), flush=True)
    return metrics


if __name__ == "__main__":
    main()
