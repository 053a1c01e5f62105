"""What the benchmark makes from `--seed` and hands to the program and to the
reference alike: speech-like waveforms, their whisper log-mels, token ids,
and the model's float weights.

The log-mel is a copy of the port's `ops/audio.py` `whisper_log_mel` (and
its slaney filterbank), so the benchmark makes its inputs without calling
the program.  The weights follow the scales of the port's
`scripts/create_seed_model.py` `seed_state_dict` (0.02 for matrices, 1e-3
for vectors, norm scales and Snake alphas near 1, the Llama's RMSNorm at
0.01, fan-in scaled DiT matrices, codebook statistics ones), drawn on the
device in one `torch.randn` call per dtype rather than leaf by leaf.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

SAMPLE_RATE = 16000
HOP = 160


def window_samples(whisper) -> int:
    """Samples of the encoder's window: two mel frames a position (30 s
    for whisper-large-v3's 1500)."""
    return 2 * whisper.max_source_positions * HOP


def _hz_to_mel_slaney(f):
    f = np.asarray(f, dtype=np.float64)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz, min_log_hz / f_sp
                    + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep,
                    f / f_sp)


def _mel_to_hz_slaney(m):
    m = np.asarray(m, dtype=np.float64)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel,
                    min_log_hz * np.exp(logstep * (m - min_log_mel)), m * f_sp)


@functools.lru_cache(maxsize=4)
def mel_filterbank_slaney(sr: int, n_fft: int, n_mels: int) -> np.ndarray:
    """librosa.filters.mel(htk=False, norm='slaney'): [n_mels, 1 + n_fft//2]."""
    fft_freqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    mel_pts = np.linspace(_hz_to_mel_slaney(0.0), _hz_to_mel_slaney(sr / 2.0),
                          n_mels + 2)
    hz_pts = _mel_to_hz_slaney(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts.reshape(-1, 1) - fft_freqs.reshape(1, -1)
    lower = -ramps[:-2] / fdiff[:-1].reshape(-1, 1)
    upper = ramps[2:] / fdiff[1:].reshape(-1, 1)
    weights = np.maximum(0.0, np.minimum(lower, upper))
    weights *= (2.0 / (hz_pts[2:n_mels + 2] - hz_pts[:n_mels])).reshape(-1, 1)
    return weights.astype(np.float32)


def whisper_log_mel(audio: torch.Tensor, n_mels: int, n_fft: int = 400,
                    hop: int = HOP) -> torch.Tensor:
    """audio [B, N] at 16 kHz -> log-mel [B, n_mels, N / hop]."""
    x = audio.float()
    pad = n_fft // 2
    xp = F.pad(x[:, None], (pad, pad), mode="reflect")[:, 0]
    frames = xp.unfold(-1, n_fft, hop)
    k = torch.arange(n_fft, dtype=torch.float32, device=x.device)
    window = 0.5 - 0.5 * torch.cos(2.0 * torch.pi * k / n_fft)
    spec = torch.fft.rfft(frames * window, n=n_fft, dim=-1)
    mag2 = (spec.real ** 2 + spec.imag ** 2).transpose(1, 2)[..., :-1]
    fb = torch.from_numpy(mel_filterbank_slaney(SAMPLE_RATE, n_fft, n_mels)
                          ).to(x.device)
    log_spec = torch.log10(torch.clamp(torch.einsum("mf,bft->bmt", fb, mag2),
                                       min=1e-10))
    gmax = log_spec.amax(dim=(-2, -1), keepdim=True)
    return (torch.maximum(log_spec, gmax - 8.0) + 4.0) / 4.0


def speech_like(durations_s: Sequence[float], n_samples: int,
                gen: torch.Generator, device) -> torch.Tensor:
    """[B, n_samples] waveforms: a gliding voiced tone with five
    harmonics and syllable-rate amplitude bursts, plus noise, for each
    row's duration; silence (zeros, as whisper pads) after it."""
    b = len(durations_s)
    t = torch.arange(n_samples, device=device) / SAMPLE_RATE
    f0 = 100.0 + 120.0 * torch.rand((b, 1), generator=gen, device=device)
    glide = 0.15 * torch.rand((b, 1), generator=gen, device=device)
    rate = 3.0 + 2.0 * torch.rand((b, 1), generator=gen, device=device)
    phase = torch.cumsum(f0 * (1.0 + glide * torch.sin(0.7 * t)), dim=1
                         ) * (2 * torch.pi / SAMPLE_RATE)
    voiced = sum(torch.sin(h * phase) / h for h in range(1, 6))
    envelope = torch.clamp(torch.sin(torch.pi * rate * t), min=0.0) ** 0.5
    noise = torch.randn((b, n_samples), generator=gen, device=device)
    wav = 0.2 * voiced * envelope + 0.01 * noise
    ends = torch.tensor([int(d * SAMPLE_RATE) for d in durations_s],
                        device=device)
    return torch.where(torch.arange(n_samples, device=device)[None]
                       < ends[:, None], wav, torch.zeros_like(wav))


def token_rows(counts: Sequence[int], width: int, vocab: int,
               gen: torch.Generator, device, low: int = 100,
               high: int = 20000, per_word: int = 2):
    """Random token ids [B, width] (zero past each row's count), the
    counts [B] and word ids (`per_word` tokens a word)."""
    b = len(counts)
    ids = torch.randint(low, high, (b, width), generator=gen,
                        device=device) % vocab
    lengths = torch.tensor(list(counts), device=device)
    pos = torch.arange(width, device=device)[None]
    ids = torch.where(pos < lengths[:, None], ids, torch.zeros_like(ids))
    words = (pos // per_word).expand(b, -1).contiguous()
    return ids, lengths, words


def _kinds(model: torch.nn.Module):
    near_one, rms = set(), set()
    for name, mod in model.named_modules():
        if isinstance(mod, (torch.nn.LayerNorm, torch.nn.GroupNorm)):
            near_one.add(f"{name}.weight")
        elif type(mod).__name__ == "RMSNorm":
            rms.add(f"{name}.weight")
    return near_one, rms


def seeded_state_dict(model: torch.nn.Module, seed: int, device,
                      prefixes: Optional[Sequence[str]] = None
                      ) -> Dict[str, torch.Tensor]:
    """Weights for every floating entry of `model`'s state dict (a model
    built on the meta device will do), drawn with one generator seeded
    `seed` on `device`: one standard-normal draw per dtype, sliced and
    scaled leaf by leaf.  `prefixes` keeps the entries under them (the
    draws are the same whichever are kept)."""
    near_one, rms = _kinds(model)
    entries = list(model.state_dict().items())
    totals: Dict[torch.dtype, int] = {}
    for _, ref in entries:
        if ref.is_floating_point():
            totals[ref.dtype] = totals.get(ref.dtype, 0) + ref.numel()
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = {dt: torch.randn(n, generator=gen, device=device, dtype=dt)
            for dt, n in sorted(totals.items(), key=lambda kv: str(kv[0]))}
    offsets = {dt: 0 for dt in flat}
    sd = {}
    for name, ref in entries:
        if not ref.is_floating_point():
            continue
        n, dt = ref.numel(), ref.dtype
        r = flat[dt][offsets[dt]:offsets[dt] + n].view(ref.shape)
        offsets[dt] += n
        if prefixes is not None and not name.startswith(tuple(prefixes)):
            continue
        dit_matrix = (".estimator." in name and ref.dim() == 2
                      and (".attn1." in name or ".ff.net." in name))
        if name in near_one or name.endswith(".alpha"):
            r.mul_(0.02).add_(1.0)
        elif name in rms:
            r.mul_(0.01)
        elif name.endswith(("cluster_size", "initted")):
            r.fill_(1.0)
        elif dit_matrix:
            r.mul_(ref.shape[1] ** -0.5)
        elif ref.dim() >= 2:
            r.mul_(0.02)
        else:
            r.mul_(1e-3)
        sd[name] = r
    return sd
