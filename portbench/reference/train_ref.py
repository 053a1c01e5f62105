"""The stage-1 step, plain: the frozen copies of the audio tower and the S3
speech decoder in float32, autograd, the global-norm clip and Adam.

Parameters are held at the precision the configuration states for them
(bfloat16: each update is rounded to it, as the program's parameters are),
while every product, the gradients and Adam's moments are float32.  The
frozen encoder runs under no_grad in blocks of rows, the S3 stack forward
and backward in blocks of rows (each block's mean loss weighted by its
share of the batch's targets, which is what the whole batch's mean is),
and the aggregator and the RVQ over the whole batch, so the EMA update and
the commit loss see every row at once.
"""

from __future__ import annotations

import math
import re
from typing import Dict, List, Sequence

import torch

from portbench.reference.losses import IGNORE_ID
from portbench.reference.masking import length_mask
from portbench.reference.segment import segment_mean_pool



def _segment(tower, enc, ids, lengths, words):
    """The tower's segmenter over precomputed encoder states (the copy's
    `_segment` after its `_encode`)."""
    cfg = tower.config
    b, dev = ids.shape[0], ids.device
    prompt = torch.tensor(cfg.whisper.decoder_prompt, dtype=torch.long,
                          device=dev)[None].expand(b, -1)
    eos = torch.full((b, 1), cfg.whisper.eos_token_id, dtype=torch.long,
                     device=dev)
    tokens = torch.cat([prompt, ids.long(), eos], dim=1)
    n_prompt = prompt.shape[1]
    out, _ = tower.decoder(tokens, enc["last_hidden"].to(tower.seg_dtype),
                           enc["target_hidden"].to(tower.seg_dtype),
                           input_lengths=lengths + n_prompt + 1)
    feats = out[:, n_prompt:-1]
    if cfg.is_word_level:
        feats = segment_mean_pool(feats, words, lengths)
    return feats


class Stage1Reference:
    """`tower` and `s3`: the copies in float32 holding the configuration's
    weights; `trainable`: regexes over the names "audio_tower.*" /
    "speech_decoder.*" (the phase's); `store`: {name: the dtype the
    configuration holds that parameter in}."""

    def __init__(self, tower, s3, trainable: Sequence[str], lr: float,
                 clip: float, store: Dict[str, torch.dtype], block_rows: int,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_commit: float = 1.0):
        self.tower, self.s3 = tower, s3
        self.lr, self.clip, self.store = lr, clip, store
        self.b1, self.b2, self.eps = b1, b2, eps
        self.block_rows, self.weight_commit = block_rows, weight_commit
        named = [("audio_tower." + n, p) for n, p in tower.named_parameters()]
        named += [("speech_decoder." + n, p) for n, p in s3.named_parameters()]
        self.params = {}
        for n, p in named:
            train = any(re.search(rx, n) for rx in trainable)
            p.requires_grad_(train)
            if train:
                self.params[n] = p
        self.m = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.count = 0

    def loss_and_grads(self, batch: Dict, draws: Dict) -> float:
        tower, s3 = self.tower, self.s3
        ids, lengths = batch["asr_token_ids"], batch["asr_token_lengths"]
        b = ids.shape[0]
        blocks = [slice(i, min(i + self.block_rows, b))
                  for i in range(0, b, self.block_rows)]
        with torch.no_grad():
            parts = [tower._encode(batch["audio_features"][sl])
                     for sl in blocks]
        enc = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
        del parts
        feats = _segment(tower, enc, ids, lengths, batch["asr_word_ids"])
        del enc
        vq = tower.vq.rvq(feats, mask=length_mask(lengths, feats.shape[1]),
                          train=True, drop_after=draws["drop_after"],
                          dead_picks=draws["dead_picks"])
        q = vq["quantized_feats"]
        qd = q.detach().requires_grad_()
        s3_len = batch["speech_token_lengths"]
        targets = torch.where(s3_len > 0, s3_len + 1, torch.zeros_like(s3_len))
        total = float(targets.sum())
        ce = 0.0
        for sl in blocks:
            out = s3(batch["speaker_embeds"][sl], qd[sl], lengths[sl],
                     ids[sl], lengths[sl], batch["speech_token_ids"][sl],
                     s3_len[sl])
            share = float((out["labels"] != IGNORE_ID).sum()) / total
            part = out["loss"] * share
            part.backward()
            ce += float(part.detach())
            del out, part
        commit = vq["commit_loss"] * self.weight_commit
        torch.autograd.backward([commit, q], [torch.ones_like(commit),
                                              qd.grad])
        return ce + float(commit.detach()), float(commit.detach())

    @torch.no_grad()
    def step(self, batch: Dict, draws: Dict) -> Dict:
        """One step -> {"loss", "commit", "grads": {name: the clipped
        gradient}}."""
        for p in self.params.values():
            p.grad = None
        with torch.enable_grad():
            loss, commit = self.loss_and_grads(batch, draws)
        grads = {n: (torch.zeros_like(p) if p.grad is None else p.grad)
                 for n, p in self.params.items()}
        norm = math.sqrt(sum(float((g * g).sum()) for g in grads.values()))
        scale = self.clip / max(norm, self.clip) if self.clip else 1.0
        self.count += 1
        bc1 = 1 - self.b1 ** self.count
        bc2 = 1 - self.b2 ** self.count
        for n, p in self.params.items():
            g = grads[n] * scale
            grads[n] = g
            self.m[n].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[n].mul_(self.b2).add_(g * g, alpha=1 - self.b2)
            u = (self.m[n] / bc1) / ((self.v[n] / bc2).sqrt() + self.eps)
            p.copy_((p - self.lr * u).to(self.store[n]).float())
            p.grad = None
        return {"loss": loss, "commit": commit, "grads": grads}


def leaf_gaps(program: Dict[str, float], reference: Dict[str, float],
              ref_grad: Dict[str, float], floor: float = 1e-3) -> float:
    """The worst leaf's gap between the program's norm and the
    reference's, over the larger of the reference's norm of that leaf and
    the median leaf's.  Leaves whose reference gradient is under `floor`
    of the median leaf's (nought to rounding: they move by round-off
    alone) are left out."""
    med_grad = _median(list(ref_grad.values()))
    keep = [n for n in reference if ref_grad[n] >= floor * med_grad]
    med = _median([reference[n] for n in keep])
    return max(abs(program[n] - reference[n]) / max(reference[n], med)
               for n in keep)


def _median(xs: List[float]) -> float:
    xs = sorted(xs)
    k = len(xs) // 2
    return xs[k] if len(xs) % 2 else 0.5 * (xs[k - 1] + xs[k])
