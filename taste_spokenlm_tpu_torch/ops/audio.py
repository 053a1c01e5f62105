"""Audio frontend (counterpart of the JAX ops/audio.py): the whisper
log-mel, the kaldi fbank of the speaker path and the windowed-sinc
resampler, as plain PyTorch over batched tensors.

* Whisper log-mel: hann(400) periodic window, hop 160, center/reflect
  padding, last frame dropped, |.|^2, slaney mel filterbank, clamp 1e-10,
  log10, clip at (global max - 8), then (x + 4) / 4.
* Kaldi fbank-80: 25 ms povey-windowed frames, 10 ms shift, snip-edges, DC
  removal, pre-emphasis 0.97, FFT padded to 512, HTK mel scale, log with an
  epsilon floor (torchaudio.compliance.kaldi.fbank, dither 0).
* Resampling: the polyphase hann-windowed sinc of torchaudio's default
  `Resample` (lowpass_filter_width 6, rolloff 0.99), one strided conv1d.
* Flow mel (the flow step's targets): 22.05 kHz, (n_fft - hop) / 2
  reflect padding, hann(1024) periodic, hop 256, sqrt(|.|^2 + 1e-9),
  slaney filterbank 0-8 kHz, log(clamp 1e-5), time-major.

The filterbanks and the resampling kernel are host-side numpy constants,
as in JAX.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

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


def _hz_to_mel_htk(f):
    return 1127.0 * np.log(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def _mel_to_hz_htk(m):
    return 700.0 * (np.exp(np.asarray(m, dtype=np.float64) / 1127.0) - 1.0)


@functools.lru_cache(maxsize=8)
def mel_filterbank_kaldi(sr: int = 16000, padded_n_fft: int = 512,
                         n_mels: int = 80, low_freq: float = 20.0,
                         high_freq: float = 0.0) -> np.ndarray:
    """Kaldi mel banks (HTK scale, unnormalized triangles) over the padded
    FFT bins, as torchaudio.compliance.kaldi.get_mel_banks:
    [n_mels, padded_n_fft // 2] (the nyquist bin dropped)."""
    if high_freq <= 0.0:
        high_freq = sr / 2.0 + high_freq
    n_bins = padded_n_fft // 2
    fft_bin_width = sr / padded_n_fft
    mel_low = _hz_to_mel_htk(low_freq)
    mel_high = _hz_to_mel_htk(high_freq)
    mel_delta = (mel_high - mel_low) / (n_mels + 1)
    mel_of_bin = _hz_to_mel_htk(np.arange(n_bins, dtype=np.float64)
                                * fft_bin_width)
    out = np.zeros((n_mels, n_bins), dtype=np.float64)
    for m in range(n_mels):
        left, center, right = (mel_low + m * mel_delta,
                               mel_low + (m + 1) * mel_delta,
                               mel_low + (m + 2) * mel_delta)
        up = (mel_of_bin - left) / (center - left)
        down = (right - mel_of_bin) / (right - center)
        out[m] = np.maximum(0.0, np.minimum(up, down))
    return out.astype(np.float32)


def hann_window(n: int, device=None) -> torch.Tensor:
    """Periodic hann window (torch.hann_window's default), float32."""
    k = torch.arange(n, dtype=torch.float32, device=device)
    return 0.5 - 0.5 * torch.cos(2.0 * torch.pi * k / n)


def povey_window(n: int, device=None) -> torch.Tensor:
    """Kaldi's "povey" window: the symmetric hann window ** 0.85."""
    k = torch.arange(n, dtype=torch.float32, device=device)
    return (0.5 - 0.5 * torch.cos(2.0 * torch.pi * k / (n - 1))) ** 0.85


def frame_signal(x: torch.Tensor, frame_length: int, hop: int) -> torch.Tensor:
    """[..., T] -> [..., 1 + (T - frame_length) // hop, frame_length]."""
    return x.unfold(-1, frame_length, hop)


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
    frames = frame_signal(xp, n_fft, hop)                 # [B, n, n_fft]
    spec = torch.fft.rfft(frames * hann_window(n_fft, x.device), n=n_fft,
                          dim=-1)
    mag2 = (spec.real ** 2 + spec.imag ** 2).transpose(1, 2)[..., :-1]
    fb = torch.from_numpy(mel_filterbank_slaney(sr, n_fft, n_mels)).to(x.device)
    mel = torch.einsum("mf,bft->bmt", fb, mag2)
    log_spec = torch.log10(torch.clamp(mel, min=1e-10))
    gmax = log_spec.amax(dim=(-2, -1), keepdim=True)
    log_spec = torch.maximum(log_spec, gmax - 8.0)
    return (log_spec + 4.0) / 4.0


def flow_mel(audio: torch.Tensor, sr: int = 22050, n_fft: int = 1024,
             hop: int = 256, n_mels: int = 80, fmin: float = 0.0,
             fmax: float = 8000.0) -> torch.Tensor:
    """audio [B, T] (or [T]) in [-1, 1] at 22.05 kHz -> log-mel
    [B, T // hop, n_mels], the CosyVoice / Matcha mel the flow is trained
    to produce."""
    if audio.dim() == 1:
        audio = audio[None]
    pad = (n_fft - hop) // 2
    xp = F.pad(audio.float()[:, None], (pad, pad), mode="reflect")[:, 0]
    frames = frame_signal(xp, n_fft, hop) * hann_window(n_fft, audio.device)
    spec = torch.fft.rfft(frames, n=n_fft, dim=-1)
    mag = torch.sqrt(spec.real ** 2 + spec.imag ** 2 + 1e-9)
    fb = torch.from_numpy(mel_filterbank_slaney(sr, n_fft, n_mels, fmin,
                                                fmax)).to(audio.device)
    mel = torch.einsum("mf,btf->btm", fb, mag)
    return torch.log(torch.clamp(mel, min=1e-5))


def mel_frame_length(sample_length, hop: int = 160):
    """Valid mel frames for a sample count."""
    return sample_length // hop


def kaldi_fbank(audio: torch.Tensor, sr: int = 16000, n_mels: int = 80,
                frame_length_ms: float = 25.0, frame_shift_ms: float = 10.0,
                preemphasis: float = 0.97, remove_dc: bool = True
                ) -> torch.Tensor:
    """Log mel-filterbank features as torchaudio.compliance.kaldi.fbank
    (dither 0): audio [B, T] (or [T]) -> float32 [B, 1 + (T - 400) // 160,
    n_mels] (snip_edges).  Computed in float64: the log of a nearly empty
    mel bin (pre-emphasis leaves little below 100 Hz) is ill-conditioned,
    and a float32 FFT puts it ~6e-5 of the largest feature off."""
    if audio.dim() == 1:
        audio = audio[None]
    win = int(sr * frame_length_ms / 1000.0)      # 400
    hop = int(sr * frame_shift_ms / 1000.0)       # 160
    padded_n_fft = 1 << (win - 1).bit_length()    # 512
    frames = frame_signal(audio.double(), win, hop)
    if remove_dc:
        frames = frames - frames.mean(dim=-1, keepdim=True)
    if preemphasis:
        prev = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
        frames = frames - preemphasis * prev
    frames = frames * povey_window(win, audio.device).double()
    spec = torch.fft.rfft(frames, n=padded_n_fft, dim=-1)
    power = (spec.real ** 2 + spec.imag ** 2)[..., : padded_n_fft // 2]
    fb = torch.from_numpy(mel_filterbank_kaldi(sr, padded_n_fft, n_mels)).to(
        audio.device, torch.float64)
    mel = torch.einsum("mf,bnf->bnm", fb, power)
    return torch.log(torch.clamp(mel, min=float(np.finfo(np.float32).eps))
                     ).float()


def speaker_fbank_features(audio: torch.Tensor) -> torch.Tensor:
    """The CAM++ speaker embedder's input: fbank-80 less its mean over
    time."""
    feats = kaldi_fbank(audio).double()
    return (feats - feats.mean(dim=1, keepdim=True)).float()


@functools.lru_cache(maxsize=16)
def _resample_kernel_np(orig_freq: int, new_freq: int,
                        lowpass_filter_width: int = 6, rolloff: float = 0.99
                        ) -> Tuple[np.ndarray, int, int, int]:
    """Polyphase windowed-sinc kernel (torchaudio sinc_interp_hann) ->
    (kernel [new/gcd, 1, K], orig/gcd, new/gcd, width)."""
    g = math.gcd(orig_freq, new_freq)
    orig, new = orig_freq // g, new_freq // g
    base_freq_hz = min(orig, new) / 2.0 * rolloff
    width = int(np.ceil(lowpass_filter_width * orig / base_freq_hz))
    idx = np.arange(-width, width + orig, dtype=np.float64)[None] / orig
    t = np.arange(0, -new, -1, dtype=np.float64)[:, None] / new + idx
    t = np.clip(t * base_freq_hz, -lowpass_filter_width, lowpass_filter_width)
    window = np.cos(t * np.pi / lowpass_filter_width / 2) ** 2
    scale = base_freq_hz / orig
    kernel = np.where(t == 0, 1.0, np.sinc(t)) * window * scale
    return kernel.astype(np.float32)[:, None, :], orig, new, width


def resample(audio: torch.Tensor, orig_freq: int, new_freq: int
             ) -> torch.Tensor:
    """audio [B, T] at orig_freq -> [B, ceil(new * T / orig)] at new_freq
    (torchaudio.transforms.Resample's defaults), one strided conv1d."""
    if orig_freq == new_freq:
        return audio
    kernel, orig, new, width = _resample_kernel_np(orig_freq, new_freq)
    b, t = audio.shape
    padded = F.pad(audio.float(), (width, width + orig))
    out = F.conv1d(padded[:, None], torch.from_numpy(kernel).to(audio.device),
                   stride=orig)                       # [B, new, frames]
    out = out.transpose(1, 2).reshape(b, -1)
    return out[:, :int(math.ceil(new * t / orig))]
