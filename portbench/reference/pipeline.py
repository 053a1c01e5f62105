"""The plain reference: the frozen float32 copies of the audio tower, the S3
speech decoder, the flow and HiFT, loaded with the benchmark's float
weights, and the comparisons that decide `correct`.

Nothing here imports the program: the weights come from
`portbench.inputs.seeded_state_dict` (the same draws the program was
given), the configuration from the configuration file, and the program's
outputs only as the things judged.  Matrix products run in true float32
(TF32 off) unless a control asks for a lower precision.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import torch

from portbench.reference.audio_tower import TasteAudioTower
from portbench.reference.config import TasteConfig
from portbench.reference.generator import VoiceGenerator
from portbench.reference.masking import length_mask
from portbench.reference.sampling import mask_top_k
from portbench.reference.speech_decoder import TasteSpeechDecoder


@contextlib.contextmanager
def matmul_precision(tf32: bool = False):
    """True float32 products (the reference), or TF32 (a control)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def reference_config(float_model: Dict) -> TasteConfig:
    """The float layout of the configuration with every kernel route off."""
    def tuples(d):
        if isinstance(d, dict):
            return {k: tuples(v) for k, v in d.items()}
        return tuple(tuples(v) for v in d) if isinstance(d, list) else d
    cfg = TasteConfig.from_dict(tuples(float_model))
    return cfg.replace(flow=cfg.flow.replace(fused_dit_serving=False),
                       hift=cfg.hift.replace(pallas_conv=False))


def _sub(sd: Dict, prefix: str) -> Dict:
    return {k[len(prefix):]: v.float() for k, v in sd.items()
            if k.startswith(prefix)}


def build(cfg: TasteConfig, sd: Dict, parts=("tower", "s3", "voice"),
          device=None) -> Dict[str, torch.nn.Module]:
    """The reference modules of `parts`, float32, in eval mode."""
    out = {}
    with (torch.device(device) if device is not None
          else contextlib.nullcontext()):
        if "tower" in parts:
            out["tower"] = TasteAudioTower(cfg.audio_tower)
            out["tower"].load_state_dict(_sub(sd, "audio_tower."), strict=True)
        if "s3" in parts:
            out["s3"] = TasteSpeechDecoder(cfg.speech_decoder)
            out["s3"].load_state_dict(_sub(sd, "speech_decoder."), strict=True)
        if "voice" in parts:
            out["voice"] = VoiceGenerator(cfg.flow, cfg.hift)
            out["voice"].load_state_dict(_sub(sd, "voice_generator."),
                                         strict=True)
    for m in out.values():
        m.to(device).eval()
    return out


# ---------------------------------------------------------------------------
# the comparisons
# ---------------------------------------------------------------------------


@torch.no_grad()
def tower_err(tower: TasteAudioTower, mel, ids, lengths, words, indices,
              z) -> float:
    """The tower's taste against the reference: the larger of the relative
    RMS error of the RVQ's input `z` [B, T, Dc] (the program's
    `project_in` output) over the valid positions, and the widest gap, over
    the valid positions and live levels, by which the code the program
    chose (`indices` [B, T, Q]) lies farther from the reference's residual
    than the reference's nearest code, as a share of the residual's
    energy.  The residual follows the program's choices, so one near tie
    does not move the later levels."""
    feats = tower._segment(mel, ids, lengths, words)
    rvq = tower.vq.rvq
    z_ref = (rvq.project_in(feats) if rvq.needs_projection else feats).float()
    embed = rvq.embeds().float()
    valid = length_mask(lengths, z_ref.shape[1])
    err = rel_rms(z, z_ref, valid)
    r = z_ref[valid]                                   # [N, Dc]
    idx = indices[valid].long().to(r.device)           # [N, Q]
    worst = 0.0
    for q in range(embed.shape[0]):
        live = idx[:, q] >= 0
        if not bool(live.any()):
            continue
        d = torch.cdist(r[live], embed[q]) ** 2
        chosen = d.gather(1, idx[live, q:q + 1])[:, 0]
        energy = (r[live] ** 2).sum(-1).clamp_min(1e-30)
        worst = max(worst, float(((chosen - d.min(-1).values) / energy).max()))
        r = r.clone()
        r[live] = r[live] - embed[q][idx[live, q]]
    return max(err, worst)


def audio_unit_embeds(tower: TasteAudioTower, indices) -> torch.Tensor:
    """The quantized taste embeds of the program's indices (-1: no code)."""
    return tower.vq.rvq.get_output_from_indices(indices.long())


@torch.no_grad()
def s3_logits(s3: TasteSpeechDecoder, spk, embeds, ids, lengths, tokens,
              n_tokens: int) -> torch.Tensor:
    """The reference's logits [n_tokens, V+1] for the served S3 tokens of
    one row (B = 1), teacher-forced: position s scores token s."""
    out = s3(spk, embeds, lengths, ids, lengths, tokens[:, :n_tokens],
             torch.tensor([n_tokens], device=tokens.device))
    start = 2 + int(lengths[0])
    return out["logits"][0, start:start + n_tokens].float()


def s3_gap(logits, tokens, gumbel, min_len: int, eos: int,
           top_k: int) -> float:
    """The widest gap, over the served steps, by which the served token's
    score (logit + the step's Gumbel draw) lies below the best score among
    the reference's top-k logits, as the sampler chooses.  logits
    [n, V+1]; tokens [n]; gumbel [n, V+1]."""
    n = logits.shape[0]
    lg = logits.clone()
    steps = torch.arange(n, device=lg.device)
    lg[steps < min_len, eos] = float("-inf")
    best = (mask_top_k(lg, top_k) + gumbel).max(dim=-1).values
    served = (logits + gumbel).gather(1, tokens[:, None].long())[:, 0]
    return float((best - served).clamp_min(0).max()) if n else 0.0


def rel_rms(got, want, valid) -> float:
    """||got - want|| / ||want|| over the positions `valid` holds."""
    diff = (got.float() - want.float())[valid]
    base = want.float()[valid]
    return float(diff.norm() / base.norm().clamp_min(1e-30))


@torch.no_grad()
def flow_err(voice: VoiceGenerator, tokens, n_tokens: int, spk, mel_len_max,
             z, mel) -> float:
    """The program's mel against the reference flow's for the same token
    row as the program was given (its full width, `n_tokens` valid),
    speaker and start noise: relative RMS of what the flow added to z over
    the valid frames."""
    ref, mel_lengths = voice.flow.inference(
        tokens, torch.tensor([n_tokens], device=tokens.device), spk,
        mel_len_max, z=z)
    valid = length_mask(mel_lengths, mel_len_max)
    return rel_rms(mel.float() - z, ref - z, valid)


@torch.no_grad()
def hift_err(voice: VoiceGenerator, mel, mel_frames: int, phase, noise,
             wav) -> float:
    """The program's waveform against the reference HiFT's, run on the
    program's mel with the same source draws: relative RMS over the valid
    samples."""
    ref = voice.hift(mel.float(), phase, noise)
    n = mel_frames * (ref.shape[1] // mel.shape[1])
    valid = torch.arange(ref.shape[1], device=ref.device)[None] < n
    return rel_rms(wav, ref, valid)


def lower_precision(module: torch.nn.Module, kind: str,
                    group: int = 128) -> torch.nn.Module:
    """A control: the module's matrix and convolution weights (and, for
    "fp8", their inputs) rounded to a lower precision in place.  "int8":
    symmetric per output channel; "int4": symmetric per group of `group`
    inputs of each output; "fp8": e4m3 with one scale a tensor."""
    def fake(w, k):
        if k == "fp8":
            s = w.abs().amax().clamp_min(1e-30) / 448.0
            return (w / s).to(torch.float8_e4m3fn).float() * s
        levels = 127 if k == "int8" else 7
        flat = w.reshape(w.shape[0], -1)
        g = flat.shape[1] if k == "int8" else min(group, flat.shape[1])
        if flat.shape[1] % g:
            g = flat.shape[1]
        blocks = flat.reshape(flat.shape[0], -1, g)
        s = blocks.abs().amax(-1, keepdim=True).clamp_min(1e-30) / levels
        q = torch.clamp(torch.round(blocks / s), -levels - (k == "int4"),
                        levels)
        return (q * s).reshape(w.shape)

    with torch.no_grad():
        for m in module.modules():
            w = getattr(m, "weight", None)
            if not isinstance(w, torch.nn.Parameter) or w.dim() < 2:
                continue
            if isinstance(m, torch.nn.Embedding):
                continue
            w.copy_(fake(w.float(), kind))
            if kind == "fp8":
                m.register_forward_pre_hook(
                    lambda _m, args: (fake(args[0].float(), "fp8")
                                      .to(args[0].dtype),) + args[1:])
    return module
