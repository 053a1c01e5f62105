"""The serving tiers' fidelity gate: the bf16, int8 and int4 serving
layouts against the float model, on one set of random weights.

Counterpart of the JAX repo's scripts/full_arch_parity.py `run_serving`
(:424) and `_serving_agreement` (:699).  Rows:

  f32          the float model with its LoRA adapters unmerged (ground truth)
  bf16_merged  LoRA merged, bf16 decoders (the audio tower f32)
  int8         the serving layout (quant.serving_config): int8 Llama and S3
               stack with the int4 tied head, fused qkv, fused MLPs, fused
               DiT blocks and the kernel convs
  int4         the same in int4

Each row runs, at B = 1, a greedy joint decode of 64 steps from a 40-token
prefix (text top_p 0, repetition penalty 1.1), the synthesis of 128 asr
tokens from the f32 row's taste rows (512 S3 steps at most, sampling_k 1,
904 mel frames), the flow alone on the f32 row's S3 tokens from one fixed
CFM noise tensor, and the teacher-forced spoken LM (`forward_spoken_llm`)
over the prefix.  Metrics per row against the f32 row: the greedy text
and taste trajectories' agreement and first divergence, the S3
trajectory's, the flow mel's relative error, and the teacher-forced
ones: the text argmax's agreement over every labelled position
(tf_text_agreement_raw) and over the positions where the f32 row's top-2
margin exceeds twice the row's largest logit difference
(tf_text_agreement_decided, 1.0 where there is none; their share
tf_decided_fraction), and the taste argmax's agreement over the labelled
taste positions (tf_taste_agreement).

Beside them, per row, the f32 row's top-2 logit margin and the row's
largest logit difference, as medians over the shared steps and at the
first divergence (text and S3): a divergence where the margin is below
the difference is a near-tie that the row's rounding or quantization
flips.

Each layout also gets a float twin: the f32 model, on the float code path
(no serving kernel, f32 products), loaded with the layout's own weights
dequantized (quant.dequantized_state_dict).  The twin's trajectories
against the f32 row show what the layout's weights alone do; the row
against its twin (against_twin: text and S3 logits on their shared
history, the flow's mel - z) shows what its kernels and bf16 products
add, and is the check: every row within TWIN_TOL.  `--reach` adds the
int8 layout with the S3 stack's FFN W2 scales doubled in every layer,
held against the int8 twin: the check must catch it.

Weights: every float leaf of two or more dimensions 0.02 x N(0, 1), every
smaller one 1e-3 x N(0, 1), integers 0, the codebook's `initted` 1 (as
`_fill_variables_f32`), from a torch generator seeded 0 (`--seed` draws
others).  The JAX script's floors: jd_text >= 0.98 (bf16_merged, int8) /
0.90 (int4), s3 >= 0.98 (bf16_merged) / 0.95 (int8), no s3 floor for
int4 (the JAX package recorded 0.668 on a TPU v5e), tf_taste >= 0.98 /
0.98 / 0.95, mel_rel_err <= 0.05 / 0.05 / 0.10.  The report lists every floor a
row misses; they are not the check, since on these near-flat logits a
trajectory holds or parts with the draw, the twins' with it.  Run as a
script at full width it exits 1 when a row leaves its twin or the reach
row does not.

Usage: python -m taste_spokenlm_tpu_torch.scripts.serving_fidelity
       [--tiny] [--reach] [--seed N] [--device cpu]

The full width needs a GPU (the f32 model alone is about 9.3 GB); `--tiny`
runs TasteConfig.tiny() at small lengths and asserts nothing, as the JAX
script's tiny mode.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from typing import Dict, Optional

import numpy as np
import torch

from taste_spokenlm_tpu_torch import quant
from taste_spokenlm_tpu_torch.config import TasteConfig
from taste_spokenlm_tpu_torch.device import resolve_device
from taste_spokenlm_tpu_torch.models.sampler import (SamplerConfig,
                                                     build_sampler_tables)
from taste_spokenlm_tpu_torch.models.taste import TasteForCausalLM

ROWS = ("f32", "bf16_merged", "int8", "int4")
# metric -> (floor, "min" or "max") per row
FLOORS = {
    "bf16_merged": {"jd_text_trajectory_agreement": (0.98, "min"),
                    "s3_trajectory_agreement": (0.98, "min"),
                    "tf_taste_agreement": (0.98, "min"),
                    "mel_rel_err": (0.05, "max")},
    "int8": {"jd_text_trajectory_agreement": (0.98, "min"),
             "s3_trajectory_agreement": (0.95, "min"),
             "tf_taste_agreement": (0.98, "min"),
             "mel_rel_err": (0.05, "max")},
    "int4": {"jd_text_trajectory_agreement": (0.90, "min"),
             "tf_taste_agreement": (0.95, "min"),
             "mel_rel_err": (0.10, "max")}}
METRICS = ("jd_tokens", "jd_text_trajectory_agreement", "jd_first_divergence",
           "jd_words", "jd_taste_trajectory_agreement",
           "tf_text_agreement_raw", "tf_text_agreement_decided",
           "tf_decided_fraction", "tf_taste_agreement", "s3_tokens",
           "s3_trajectory_agreement", "s3_first_divergence", "mel_rel_err")
# each serving row against its float twin (against_twin): the tolerances
# chip_smoke.py holds the kernels to against their plain versions (text
# logits 1.2e-2 of max |logit| on a shared history, the flow's mel - z
# 2e-2).  On an H100 at full width, seeds 0-2, the rows reach 0.98e-2
# (text), 0.73e-2 (S3) and 0.24e-2 (mel); the reach row's S3 logits 3.6e-2
# to 4.9e-2
TWIN_TOL = {"text_logit_rel_err": 1.2e-2, "s3_logit_rel_err": 1.2e-2,
            "mel_field_rel_err": 2e-2}
# the float twins' agreement with the f32 row: what the layouts' weights
# alone do to the trajectories, with no serving kernel or bf16 product
WITNESS = ("jd_text_trajectory_agreement", "jd_first_divergence",
           "jd_taste_trajectory_agreement", "tf_taste_agreement",
           "s3_trajectory_agreement", "s3_first_divergence")
REACH, REACH_TIER = "int8_w2_scales_x2", "int8"
# the JAX package's own recording of the int4 row on a TPU v5e
# (docs/FULL_ARCH_PARITY.md, serving section)
TPU_V5E_INT4_S3 = 0.668


class VocabStub:
    """A deterministic id -> subword map standing in for the Llama tokenizer
    (bench.py _VocabScan): the sampler tables' shapes and behaviour are
    those of real ones."""

    def decode(self, i):
        return (" the", "ing", ".", " end.", "!!", "a\nb", " word", "s",
                ",'", " no.", "xyz")[i % 11]


def fill_f32(model: torch.nn.Module, gen: torch.Generator) -> None:
    """Fill every entry of the model's state dict in place: float leaves of
    two or more dimensions in the JAX layout 0.02 x N(0, 1), smaller ones
    1e-3 x N(0, 1), integer and bool leaves 0, the codebook's `initted`
    flags 1.  The Snake alphas, [C] in JAX, are stored [1, C, 1] here."""
    for name, t in model.state_dict().items():
        if name.endswith("initted"):
            t.fill_(1)
        elif not t.is_floating_point():
            t.zero_()
        else:
            dims = 1 if name.endswith(".alpha") else t.dim()
            scale = 0.02 if dims >= 2 else 1e-3
            t.copy_(torch.randn(t.shape, generator=gen, device=t.device)
                    * scale)


def dense_taste(jd: Dict, max_words: int, levels: int) -> np.ndarray:
    """The decoded taste rows, dense per word ([1, max_words, L], -1 -> 0)."""
    n = max(int(jd["num_taste_words"][0]), 1)
    dense = np.zeros((1, max_words, levels), np.int64)
    dense[0, :n] = np.maximum(np.asarray(jd["taste_indices"])[0, :n], 0)
    return dense


def serving_agreement(ref: Dict, row: Dict) -> Dict:
    """The agreement metrics of one row against the f32 row (the JAX
    script's `_serving_agreement`).  Rows hold numpy arrays: "jd"
    (llm_token_ids, num_tokens, num_taste_words, taste_indices), "syn"
    (speech_token_ids, speech_token_lengths), "mel" [B, T, M] and, for the
    tf_* metrics, "tf" (text_logits, text_labels, taste_logits,
    taste_labels of the teacher-forced forward)."""
    out = {}
    n = min(int(ref["jd"]["num_tokens"][0]), int(row["jd"]["num_tokens"][0]))
    a = np.asarray(ref["jd"]["llm_token_ids"])[0, :n]
    b = np.asarray(row["jd"]["llm_token_ids"])[0, :n]
    out["jd_tokens"] = int(row["jd"]["num_tokens"][0])
    out["jd_text_trajectory_agreement"] = float((a == b).mean())
    div = np.flatnonzero(a != b)
    out["jd_first_divergence"] = int(div[0]) if len(div) else n
    nw = min(int(ref["jd"]["num_taste_words"][0]),
             int(row["jd"]["num_taste_words"][0]))
    out["jd_words"] = int(row["jd"]["num_taste_words"][0])
    if nw > 0:
        ta = np.asarray(ref["jd"]["taste_indices"])[0, :nw]
        tb = np.asarray(row["jd"]["taste_indices"])[0, :nw]
        out["jd_taste_trajectory_agreement"] = float((ta == tb).mean())
    else:                     # a greedy trajectory inside one word
        out["jd_taste_trajectory_agreement"] = None
    if "tf" in ref and "tf" in row:
        out.update(tf_agreement(ref["tf"], row["tf"]))
    sa = np.asarray(ref["syn"]["speech_token_ids"])[0]
    sb = np.asarray(row["syn"]["speech_token_ids"])[0]
    ns = min(int(ref["syn"]["speech_token_lengths"][0]),
             int(row["syn"]["speech_token_lengths"][0]))
    out["s3_tokens"] = int(row["syn"]["speech_token_lengths"][0])
    out["s3_trajectory_agreement"] = float((sa[:ns] == sb[:ns]).mean())
    sdiv = np.flatnonzero(sa[:ns] != sb[:ns])
    out["s3_first_divergence"] = int(sdiv[0]) if len(sdiv) else ns
    nf = min(ref["mel"].shape[1], row["mel"].shape[1])
    rm, om = ref["mel"][:, :nf], row["mel"][:, :nf]
    out["mel_rel_err"] = float(np.linalg.norm(om - rm)
                               / max(np.linalg.norm(rm), 1e-9))
    return {k: (round(v, 4) if isinstance(v, float) else v)
            for k, v in out.items()}


def tf_agreement(ref: Dict, row: Dict) -> Dict:
    """The teacher-forced metrics: per-position argmax agreement (no
    compounding) of the text logits over the labelled positions, raw and
    over the decided ones (the f32 row's top-2 margin above twice the
    row's largest logit difference: random weights flatten the logits),
    and of the taste logits over the labelled taste positions."""
    rtl, otl = ref["text_logits"], row["text_logits"]
    vmask = ref["text_labels"] != -1
    agree = (rtl.argmax(-1) == otl.argmax(-1)) & vmask
    drift = np.abs(rtl - otl).max(-1)
    top = np.sort(rtl, axis=-1)
    decided = (top[..., -1] - top[..., -2] > 2 * drift) & vmask
    tmask = ref["taste_labels"] != -1
    tagree = (ref["taste_logits"].argmax(-1)
              == row["taste_logits"].argmax(-1)) & tmask
    return {"tf_text_agreement_raw": float(agree.sum() / vmask.sum()),
            "tf_text_agreement_decided": (float(agree[decided].mean())
                                          if decided.any() else 1.0),
            "tf_decided_fraction": float(decided.sum()
                                         / max(vmask.sum(), 1)),
            "tf_taste_agreement": float(tagree.sum() / max(tmask.sum(), 1))}


def misses(tier: str, rep: Dict) -> list:
    """[(metric, value, floor)] of every floor of `tier` that `rep` misses."""
    return [(metric, rep[metric], floor)
            for metric, (floor, kind) in FLOORS[tier].items()
            if (rep[metric] < floor if kind == "min" else rep[metric] > floor)]


class _Inputs:
    """The shared inputs, drawn as run_serving draws them (its order of
    numpy draws from RandomState(0))."""

    def __init__(self, cfg: TasteConfig, tiny: bool, dev):
        self.b, t_tok, self.steps = (1, 8, 8) if tiny else (1, 40, 64)
        self.max_speech, self.mel_len_max = (64, 128) if tiny else (512, 904)
        rng = np.random.RandomState(0)
        word_ids = np.minimum(np.arange(t_tok) // 2, t_tok - 1)
        llm_vocab = cfg.spoken_lm.llama.vocab_size
        q = cfg.audio_tower.quantizer
        self.levels = q.num_quantizers
        t = lambda a: torch.from_numpy(np.asarray(a)).to(dev)  # noqa: E731
        self.llm_ids = t(rng.randint(100, 120000, (self.b, t_tok)) % llm_vocab)
        indices = np.full((self.b, t_tok, self.levels), -1, np.int64)
        starts = np.flatnonzero(np.diff(word_ids, prepend=-1) != 0)
        indices[:, starts] = rng.randint(0, q.codebook_size,
                                         (self.b, len(starts), self.levels))
        self.llm_indices = t(indices)
        self.lens = t(np.full((self.b,), t_tok))
        self.words = t(word_ids[None])
        self.spk = t(rng.randn(self.b, cfg.speech_decoder.spk_embed_dim)
                     .astype(np.float32))
        self.tables = {k: t(v) for k, v in
                       build_sampler_tables(VocabStub(), llm_vocab).items()}
        self.scfg = SamplerConfig(
            delay=cfg.spoken_lm.delay, delay_level=cfg.spoken_lm.delay_level,
            extra_words=self.steps, text_top_p=0.0, taste_top_p=0.0,
            text_temperature=1.0, repetition_penalty=1.1, has_prefix=True)
        n_asr = 2 * self.steps
        self.syn_ids = t(rng.randint(100, 20000, (self.b, n_asr))
                         % cfg.audio_tower.whisper.vocab_size)
        self.syn_words = t(np.minimum(np.arange(n_asr) // 2,
                                      self.steps - 1)[None])
        self.syn_lens = t(np.full((self.b,), n_asr))
        # the one CFM start noise of every row's flow
        self.z = torch.randn((self.b, self.mel_len_max, cfg.flow.output_size),
                             generator=torch.Generator(dev).manual_seed(7),
                             device=dev)


def _numpy(d: Dict, keys) -> Dict:
    return {k: d[k].cpu().numpy() for k in keys}


class _Logits:
    """Records, per decode step, the text logits the joint decode's sampler
    decides on, the argmax of the taste logits and the S3 head's logits
    (f32, B = 1)."""

    def __init__(self, model):
        self.text, self.taste, self.s3 = [], [], []
        self._lm = model.spoken_lm.language_model
        head = self._lm.logits

        def text(hidden):
            out = head(hidden)
            self.text.append(out[:, 0].float())
            return out
        self._lm.logits = text
        self._hooks = [
            model.spoken_lm.extract_for_bridge_out_llm.register_forward_hook(
                lambda mod, args, out: self.taste.append(
                    out[0][:, 0].argmax(-1))),
            model.speech_decoder.llm_decoder.register_forward_hook(
                lambda mod, args, out: self.s3.append(
                    out.float().reshape(-1, out.shape[-1])[-1:]))]

    def close(self) -> Dict:
        for hook in self._hooks:
            hook.remove()
        del self._lm.logits
        return {"text": torch.cat(self.text).cpu(),
                "taste": torch.cat(self.taste).cpu(),
                "s3": torch.cat(self.s3).cpu()}


def margins(ref: Dict, row: Dict, rep: Dict, allowed: torch.Tensor) -> Dict:
    """Why a row parts from the f32 row: over the steps before its first
    divergence (text and S3), the median top-2 margin of the f32 row's
    logits and the median largest logit difference of the row's; at that
    step, the same two numbers (text logits over the tokens the sampler
    may pick)."""
    out = {}
    for key, first, mask in (("jd", rep["jd_first_divergence"], allowed),
                             ("s3", rep["s3_first_divergence"], None)):
        lr = ref["logits"]["text" if key == "jd" else "s3"]
        lo = row["logits"]["text" if key == "jd" else "s3"]
        n = min(len(lr), len(lo))
        if mask is not None:
            lr, lo = lr[:, mask], lo[:, mask]
        top = lr[:n].topk(2, dim=-1).values
        margin = top[:, 0] - top[:, 1]
        drift = (lo[:n] - lr[:n]).abs().amax(dim=-1)
        shared = slice(0, max(min(first, n), 1))
        out[f"{key}_f32_top2_margin_median"] = margin[shared].median().item()
        out[f"{key}_logit_drift_median"] = drift[shared].median().item()
        out[f"{key}_f32_top2_margin_at_divergence"] = (
            margin[first].item() if first < n else None)
        out[f"{key}_logit_drift_at_divergence"] = (
            drift[first].item() if first < n else None)
    return out


def against_twin(twin: Dict, row: Dict, z: np.ndarray,
                 allowed: torch.Tensor) -> Dict:
    """A serving row against its float twin (the float model on the row's
    own weights, dequantized): the largest difference of their text logits
    (over the tokens the sampler may pick) and of their S3 logits, relative
    to the twin's max |logit|, over every step of the history they share
    (up to and including the first step at which a text or taste decision,
    or an S3 token, differs); and the relative error of what the flow's
    estimator added to the start noise z (mel - z, valid frames)."""
    out = {}
    lt, lr = twin["logits"], row["logits"]
    n = min(len(lt["text"]), len(lr["text"]), len(lt["taste"]),
            len(lr["taste"]))
    pick = lambda lg: torch.where(  # noqa: E731
        allowed, lg, torch.full_like(lg, -1e30)).argmax(-1)
    parted = ((pick(lt["text"][:n]) != pick(lr["text"][:n]))
              | (lt["taste"][:n] != lr["taste"][:n]).any(-1))
    shared = int(parted.nonzero()[0]) + 1 if bool(parted.any()) else n
    sa = np.asarray(twin["syn"]["speech_token_ids"])[0]
    sb = np.asarray(row["syn"]["speech_token_ids"])[0]
    ns = min(len(lt["s3"]), len(lr["s3"]), len(sa), len(sb))
    sdiv = np.flatnonzero(sa[:ns] != sb[:ns])
    s3_shared = int(sdiv[0]) + 1 if len(sdiv) else ns
    for key, steps, mask in (("text", shared, allowed),
                             ("s3", s3_shared, None)):
        a, b = lt[key][:steps], lr[key][:steps]
        if mask is not None:
            a, b = a[:, mask], b[:, mask]
        out[f"{key}_logit_rel_err"] = (
            (b - a).abs().amax(-1) / a.abs().amax(-1)).max().item()
        out[f"{key}_shared_steps"] = steps
    nf = min(twin["mel_len"], row["mel_len"])
    field = twin["mel"][:, :nf] - z[:, :nf]
    out["mel_field_rel_err"] = float(
        np.linalg.norm(row["mel"][:, :nf] - twin["mel"][:, :nf])
        / max(np.linalg.norm(field), 1e-30))
    return out


@torch.no_grad()
def run_row(model, x: _Inputs, taste_ref: Optional[np.ndarray] = None,
            mel_tokens=None) -> Dict:
    """One row: the greedy joint decode, the synthesis from `taste_ref` (the
    row's own taste rows where None), the flow on `mel_tokens` ((ids,
    lengths); the row's own S3 tokens where None) and the teacher-forced
    forward over the prefix; with the decode steps' text and S3 logits."""
    dev = x.llm_ids.device
    t0 = time.perf_counter()
    logits = _Logits(model)
    try:
        out = _run_row(model, x, taste_ref, mel_tokens)
    finally:
        out_logits = logits.close()
    # the teacher-forced forward over the prefix, outside the decode's
    # logit record
    tf = model.forward_spoken_llm(x.llm_indices, x.llm_ids, x.lens, x.words)
    out["tf"] = {k: tf[k].float().cpu().numpy() for k in
                 ("text_logits", "taste_logits", "text_labels",
                  "taste_labels")}
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return {**out, "logits": out_logits, "wall_s": time.perf_counter() - t0}


def _run_row(model, x: _Inputs, taste_ref, mel_tokens) -> Dict:
    dev = x.llm_ids.device
    jd = model.generate_completion(
        x.scfg, x.tables, x.llm_indices, x.llm_ids, x.lens, x.words, "audio",
        x.steps, generator=torch.Generator(dev).manual_seed(5))
    steps = int(jd["steps"])
    jd = _numpy(jd, ("llm_token_ids", "num_tokens", "num_taste_words",
                     "taste_indices"))
    taste = dense_taste(jd, x.steps, x.levels) if taste_ref is None \
        else taste_ref
    syn = model.synthesize_from_taste(
        x.spk, torch.from_numpy(taste).to(dev), x.syn_ids, x.syn_lens,
        x.syn_words, max_speech_steps=x.max_speech,
        mel_len_max=x.mel_len_max, sampling_k=1,
        generator=torch.Generator(dev).manual_seed(6))
    wav_finite = bool(torch.isfinite(syn["waveform"]).all())
    syn_mel = int(model.voice_generator.flow.mel_lengths(
        syn["speech_token_lengths"]).clamp(max=x.mel_len_max)[0])
    syn = _numpy(syn, ("speech_token_ids", "speech_token_lengths"))
    if mel_tokens is None:
        mel_tokens = (np.maximum(syn["speech_token_ids"], 0),
                      syn["speech_token_lengths"])

    mel, mel_len = model.voice_generator.flow.inference(
        *(torch.from_numpy(a).to(dev) for a in mel_tokens), x.spk,
        x.mel_len_max, z=x.z)
    return {"jd": jd, "jd_steps": steps, "syn": syn, "syn_mel": syn_mel,
            "mel": mel.float().cpu().numpy(), "mel_len": int(mel_len[0]),
            "taste_in": taste, "mel_tokens": mel_tokens,
            "wav_finite": wav_finite}


def _free(dev) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _build(cfg, dtype, sd: Dict, dev):
    kw = {"tower_dtype": torch.float32} if dtype != torch.float32 else {}
    with torch.device(dev):
        model = TasteForCausalLM(cfg, dtype=dtype, device=dev, **kw)
    model.load_state_dict(sd, strict=True)
    return model.eval()


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--tiny", action="store_true",
                   help="TasteConfig.tiny() at small lengths; no floor is "
                        "asserted")
    p.add_argument("--reach", action="store_true",
                   help="also run the int8 layout with the S3 stack's FFN "
                        "W2 scales doubled (information)")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the weights' generator")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Run the rows and the twins; -> the report: every row against its
    twin beyond TWIN_TOL (`twin_misses`), the metrics that catch the reach
    row (`reach.caught_by`), `gate_pass` when there are none of the first
    and, with `--reach`, some of the second; and every JAX floor a row
    misses (`floor_misses`, `floors_pass`).  Raises where the f32 row's
    trajectories are degenerate or a row's waveform is not finite."""
    args = parse(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":       # the f32 row in true f32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = TasteConfig.tiny() if args.tiny else TasteConfig.full()
    x = _Inputs(cfg, args.tiny, dev)
    report = {"config": "tiny" if args.tiny else "full", "device": dev.type,
              "decode_steps": x.steps, "max_speech_steps": x.max_speech,
              "mel_len_max": x.mel_len_max, "rows": {}}

    def log(name, rep):
        report["rows"][name] = rep
        print(json.dumps({f"serving_{name}": rep}), flush=True)

    # the f32 row: the float weights every other row derives from
    t0 = time.perf_counter()
    with torch.device(dev):
        model = TasteForCausalLM(cfg, dtype=torch.float32, device=dev)
    fill_f32(model, torch.Generator(dev).manual_seed(args.seed))
    model.eval()
    sd = model.state_dict()
    report["float_params"] = sum(p.numel() for p in model.parameters())
    report["float_init_s"] = time.perf_counter() - t0
    ref = run_row(model, x)
    allowed = ~x.tables["banned"].cpu()
    del model
    _free(dev)
    n_jd = int(ref["jd"]["num_tokens"][0])
    n_s3 = int(ref["syn"]["speech_token_lengths"][0])
    log("f32", {"jd_tokens": n_jd, "s3_tokens": n_s3,
                "mel_frames": int(ref["mel"].shape[1]),
                "wav_finite": ref["wav_finite"], "wall_s": ref["wall_s"]})
    if n_jd < x.steps // 2:
        raise RuntimeError(f"serving_fidelity: degenerate f32 joint decode: "
                           f"{n_jd} tokens")
    if n_s3 < min(64, x.max_speech // 2):
        raise RuntimeError(f"serving_fidelity: degenerate f32 S3 decode: "
                           f"{n_s3} tokens")

    def merged():
        lora, pre = cfg.spoken_lm.lora, "spoken_lm.language_model."
        out = {k: v for k, v in sd.items() if not k.startswith(pre)}
        out.update({pre + k: v for k, v in quant.merge_lora_params(
            {k[len(pre):]: v for k, v in sd.items() if k.startswith(pre)},
            lora.alpha, lora.r).items()})
        return out

    layouts = {"bf16_merged": (cfg.replace(spoken_lm=cfg.spoken_lm.replace(
        use_lora=False)), merged)}
    for tier in ("int8", "int4"):
        scfg = quant.serving_config(cfg, tier)
        layouts[tier] = (scfg, lambda scfg=scfg, tier=tier:
                         quant.serving_state_dict(sd, scfg, tier))
    if args.reach:
        def doubled():
            out = quant.serving_state_dict(sd, layouts["int8"][0], "int8")
            for k in out:
                if k.startswith("speech_decoder.llm.encoders.") \
                        and k.endswith(".feed_forward.w_2.scale"):
                    out[k] = out[k] * 2
            return out
        layouts[REACH] = (layouts["int8"][0], doubled)

    z = x.z.cpu().numpy()
    twins = {}
    for name, (row_cfg, state) in layouts.items():
        model = _build(row_cfg, torch.bfloat16, state(), dev)
        out = run_row(model, x, taste_ref=ref["taste_in"],
                      mel_tokens=ref["mel_tokens"])
        tier = REACH_TIER if name == REACH else name
        weights = (None if tier in twins else quant.dequantized_state_dict(
            model.state_dict(), row_cfg))
        del model
        _free(dev)
        if weights is not None:
            model = _build(quant.float_layout_config(row_cfg), torch.float32,
                           weights, dev)
            del weights
            twins[tier] = run_row(model, x, taste_ref=ref["taste_in"],
                                  mel_tokens=ref["mel_tokens"])
            del model
            _free(dev)
        agree = serving_agreement(ref, out)
        witness = serving_agreement(ref, twins[tier])
        log(name, {**agree, **margins(ref, out, agree, allowed),
                   "float_twin": {k: witness[k] for k in WITNESS},
                   "against_twin": against_twin(twins[tier], out, z, allowed),
                   "jd_steps": out["jd_steps"], "syn_mel_frames": out["syn_mel"],
                   "mel_frames": out["mel_len"], "wav_finite": out["wav_finite"],
                   "wall_s": out["wall_s"]})
        if not out["wav_finite"]:
            raise RuntimeError(f"serving_fidelity: {name}: non-finite "
                               "waveform")
    if args.reach:
        base, moved = report["rows"]["int8"], report["rows"][REACH]
        report["reach"] = {
            "what": "int8 with the S3 stack's FFN W2 scales x 2 in every "
                    "layer, against the int8 row and the int8 twin",
            "moved": {k: [base[k], moved[k]] for k in METRICS
                      if base[k] != moved[k]},
            "below_int8_floors": misses("int8", moved),
            "caught_by": [m for m, tol in TWIN_TOL.items()
                          if moved["against_twin"][m] > tol]}
    report["floors"] = {name: {m: list(f) for m, f in floors.items()}
                        for name, floors in FLOORS.items()}
    report["int4_s3_trajectory_agreement_tpu_v5e_jax"] = TPU_V5E_INT4_S3
    failed = [(name, *miss) for name in FLOORS
              for miss in misses(name, report["rows"][name])]
    report["floors_pass"] = not failed
    report["floor_misses"] = [
        {"row": name, "metric": m, "value": v, "floor": f}
        for name, m, v, f in failed]
    report["twin_tolerances"] = dict(TWIN_TOL)
    report["twin_misses"] = [
        {"row": name, "metric": m, "value": report["rows"][name][
            "against_twin"][m], "tolerance": tol}
        for name in ROWS[1:] for m, tol in TWIN_TOL.items()
        if report["rows"][name]["against_twin"][m] > tol]
    report["gate_pass"] = (not report["twin_misses"]
                           and (not args.reach
                                or bool(report["reach"]["caught_by"])))
    return report


if __name__ == "__main__":
    # at full width a row that leaves its twin, or a reach row that the
    # tolerances do not catch, is the script's failure
    rep = main(sys.argv[1:])
    print(json.dumps({"serving_fidelity": rep}), flush=True)
    sys.exit(0 if rep["gate_pass"] or rep["config"] == "tiny" else 1)
