"""Whisper log-mel frontend (counterpart of the JAX ops/audio.py
`whisper_log_mel`, `pad_or_trim` and `mel_filterbank_slaney`).

Hann(400) periodic window, hop 160, center/reflect padding, last frame
dropped, |.|^2, slaney mel filterbank, clamp 1e-10, log10, clip at
(global max - 8), then (x + 4) / 4.  The kaldi fbank and resampler are not
ported yet.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def _hz_to_mel_slaney(f: np.ndarray) -> np.ndarray:
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    mels = f / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = f >= min_log_hz
    return np.where(log_region, min_log_mel
                    + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep,
                    mels)


def _mel_to_hz_slaney(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    freqs = m * f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = m >= min_log_mel
    return np.where(log_region,
                    min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)


@functools.lru_cache(maxsize=8)
def mel_filterbank_slaney(sr: int = 16000, n_fft: int = 400, n_mels: int = 128,
                          fmin: float = 0.0, fmax: Optional[float] = None
                          ) -> np.ndarray:
    """librosa.filters.mel(htk=False, norm='slaney'): [n_mels, 1 + n_fft//2]."""
    if fmax is None:
        fmax = sr / 2.0
    n_freqs = 1 + n_fft // 2
    fft_freqs = np.linspace(0.0, sr / 2.0, n_freqs)
    mel_pts = np.linspace(_hz_to_mel_slaney(np.array(fmin)),
                          _hz_to_mel_slaney(np.array(fmax)), n_mels + 2)
    hz_pts = _mel_to_hz_slaney(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts.reshape(-1, 1) - fft_freqs.reshape(1, -1)
    lower = -ramps[:-2] / fdiff[:-1].reshape(-1, 1)
    upper = ramps[2:] / fdiff[1:].reshape(-1, 1)
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (hz_pts[2: n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm.reshape(-1, 1)
    return weights.astype(np.float32)


def pad_or_trim(x: torch.Tensor, n_samples: int) -> torch.Tensor:
    """Pad with zeros / trim to exactly n_samples along the last axis."""
    t = x.shape[-1]
    if t >= n_samples:
        return x[..., :n_samples]
    return F.pad(x, (0, n_samples - t))


def whisper_log_mel(audio: torch.Tensor, n_mels: int = 128, sr: int = 16000,
                    n_fft: int = 400, hop: int = 160,
                    do_pad_trim: bool = True,
                    n_samples: int = 480000) -> torch.Tensor:
    """audio [B, T] (or [T]) at 16 kHz -> log-mel [B, n_mels, n_frames]."""
    if audio.dim() == 1:
        audio = audio[None]
    if do_pad_trim:
        audio = pad_or_trim(audio, n_samples)
    x = audio.float()
    pad = n_fft // 2
    xp = F.pad(x[:, None], (pad, pad), mode="reflect")[:, 0]
    frames = xp.unfold(-1, n_fft, hop)                    # [B, n, n_fft]
    k = torch.arange(n_fft, dtype=torch.float32, device=x.device)
    window = 0.5 - 0.5 * torch.cos(2.0 * torch.pi * k / n_fft)
    spec = torch.fft.rfft(frames * window, n=n_fft, dim=-1)
    mag2 = (spec.real ** 2 + spec.imag ** 2).transpose(1, 2)[..., :-1]
    fb = torch.from_numpy(mel_filterbank_slaney(sr, n_fft, n_mels)).to(x.device)
    mel = torch.einsum("mf,bft->bmt", fb, mag2)
    log_spec = torch.log10(torch.clamp(mel, min=1e-10))
    gmax = log_spec.amax(dim=(-2, -1), keepdim=True)
    log_spec = torch.maximum(log_spec, gmax - 8.0)
    return (log_spec + 4.0) / 4.0
