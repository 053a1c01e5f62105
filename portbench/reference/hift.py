# Frozen copy of taste_spokenlm_tpu_torch/models/hift.py at commit 1a9abc6: the plain path
# that the benchmark holds the port against.  Kernel, remat and
# data-parallel routes resolve to portbench/reference/stubs.py.
"""HiFT vocoder: NSF source-filter + iSTFT head, mel -> waveform
(counterpart of the JAX models/hift.py).

Activations are channels-last [B, T, C] as in JAX, so the ResBlock convs
feed the `conv1d_same` kernel without a transpose.  Module names follow the
reference HiFTGenerator state dict (conv_pre, ups.{i}, source_downs.{i},
source_resblocks.{i}, resblocks.{j}, m_source.l_linear, f0_predictor.
condnet.{2k} / classifier, conv_post), with each weight-norm pair collapsed
into one `weight` (convert.collapse_weight_norm).

The sine source takes its random initial phases and noise as tensors (or
draws them from a `torch.Generator`), so a test can hand JAX and the port
the same numbers.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from portbench.reference.config import HiFTConfig
from portbench.reference.stubs import conv1d_same, conv1d_same_plain

# the JAX gate for the conv kernel (models/hift.py WNConv): shorter
# sequences (streaming windows) stay on the library conv
KERNEL_MIN_T = 4096


class WNConv(nn.Module):
    """Conv1d with a collapsed weight-norm weight [Cout, Cin, K], on
    channels-last input.

    With `use_kernel`, stride-1 same-padding convs whose channels are
    multiples of 128 and whose input has T >= 4096 take the `conv1d_same`
    kernel (the JAX gate).  Its [K, Cin, Cout] weight layout is prepared
    once when the state dict is loaded, not on every call."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 padding: int = 0, dilation: int = 1, use_kernel: bool = False):
        super().__init__()
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel))
        self.bias = nn.Parameter(torch.zeros(cout))
        nn.init.kaiming_uniform_(self.weight, a=5 ** 0.5)
        self.kernel_eligible = (
            use_kernel and stride == 1 and padding == (kernel - 1) * dilation // 2
            and cin % 128 == 0 and cout % 128 == 0)
        self.use_kernels = True
        if self.kernel_eligible:
            self.register_buffer("weight_kic", self._kic(), persistent=False)
            self.register_load_state_dict_post_hook(
                lambda module, _: module.refresh_kernel_weights())

    def _kic(self) -> torch.Tensor:
        return self.weight.detach().permute(2, 1, 0).contiguous()

    def refresh_kernel_weights(self) -> None:
        self.weight_kic = self._kic()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kernel_eligible and x.shape[1] >= KERNEL_MIN_T:
            conv = conv1d_same if self.use_kernels else conv1d_same_plain
            return conv(x.contiguous(), self.weight_kic, self.bias,
                        dilation=self.dilation)
        y = F.conv1d(x.transpose(1, 2), self.weight.to(x.dtype),
                     self.bias.to(x.dtype), self.stride, self.padding,
                     self.dilation)
        return y.transpose(1, 2)


class WNConvTranspose(nn.Module):
    """ConvTranspose1d with a collapsed weight-norm weight [Cin, Cout, K]
    (torch semantics: out_len = (T-1)*stride + K - 2*padding), channels-last."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int,
                 padding: int):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(torch.empty(cin, cout, kernel))
        self.bias = nn.Parameter(torch.zeros(cout))
        nn.init.kaiming_uniform_(self.weight, a=5 ** 0.5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv_transpose1d(x.transpose(1, 2), self.weight.to(x.dtype),
                               self.bias.to(x.dtype), self.stride,
                               self.padding)
        return y.transpose(1, 2)


def snake(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Snake activation x + sin^2(alpha x) / alpha; alpha [C] on the last
    axis."""
    return x + (1.0 / (alpha + 1e-9)) * torch.sin(alpha * x) ** 2


class Snake(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.ones(1, channels, 1))

    def forward(self, x):
        return snake(x, self.alpha.reshape(-1).to(x.dtype))


class ResBlock(nn.Module):
    """HiFiGAN residual block with Snake activations."""

    def __init__(self, channels: int, kernel: int = 3,
                 dilations: Sequence[int] = (1, 3, 5), use_kernel: bool = False):
        super().__init__()
        self.convs1 = nn.ModuleList(
            WNConv(channels, channels, kernel, padding=(kernel * d - d) // 2,
                   dilation=d, use_kernel=use_kernel) for d in dilations)
        self.convs2 = nn.ModuleList(
            WNConv(channels, channels, kernel, padding=(kernel - 1) // 2,
                   use_kernel=use_kernel) for _ in dilations)
        self.activations1 = nn.ModuleList(Snake(channels) for _ in dilations)
        self.activations2 = nn.ModuleList(Snake(channels) for _ in dilations)

    def forward(self, x):
        for c1, c2, a1, a2 in zip(self.convs1, self.convs2, self.activations1,
                                  self.activations2):
            x = x + c2(a2(c1(a1(x))))
        return x


class ConvRNNF0Predictor(nn.Module):
    """5x (conv k3 + ELU) + linear classifier -> |f0| [B, T]."""

    def __init__(self, in_channels: int = 80, cond_channels: int = 512):
        super().__init__()
        layers = []
        for i in range(5):
            layers += [WNConv(in_channels if i == 0 else cond_channels,
                              cond_channels, 3, padding=1), nn.ELU()]
        self.condnet = nn.Sequential(*layers)
        self.classifier = nn.Linear(cond_channels, 1)

    def forward(self, mel):
        h = self.condnet(mel)
        return torch.abs(self.classifier(h))[..., 0]


def sine_source(f0_up: torch.Tensor, sampling_rate: int, harmonics: int,
                sine_amp: float, noise_std: float, voiced_threshold: float,
                phase: Optional[torch.Tensor] = None,
                noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """f0 at the sample rate [B, Ts] -> harmonic source [B, H+1, Ts].

    `phase` [B, H+1, 1] uniform in [-pi, pi) (harmonic 0 is set to 0) and
    `noise` [B, H+1, Ts] standard normal are drawn from `generator` when not
    given."""
    b, t = f0_up.shape
    dev = f0_up.device
    h = torch.arange(1, harmonics + 2, dtype=torch.float32, device=dev)
    rads = f0_up[:, None, :] * h[None, :, None] / sampling_rate
    theta = 2.0 * np.pi * (torch.cumsum(rads, dim=-1) % 1.0)
    uv = (f0_up > voiced_threshold).float()[:, None, :]
    if phase is None:
        phase = (torch.rand((b, harmonics + 1, 1), generator=generator,
                            device=dev) * 2.0 - 1.0) * np.pi
    if noise is None:
        noise = torch.randn((b, harmonics + 1, t), generator=generator,
                            device=dev)
    phase = phase.to(dev, torch.float32).clone()
    phase[:, 0, :] = 0.0
    sines = sine_amp * torch.sin(theta + phase)
    noise_amp = uv * noise_std + (1.0 - uv) * sine_amp / 3.0
    return sines * uv + noise_amp * noise.to(dev, torch.float32)


def _dft_consts(n_fft: int):
    nf = n_fft // 2 + 1
    fwd = np.fft.rfft(np.eye(n_fft), axis=-1)
    inv_r = np.fft.irfft(np.eye(nf), n=n_fft, axis=-1)
    inv_i = np.fft.irfft(1j * np.eye(nf), n=n_fft, axis=-1)
    return [torch.from_numpy(a.astype(np.float32))
            for a in (fwd.real, fwd.imag, inv_r, inv_i)]


def _hann(n_fft: int) -> np.ndarray:
    return np.hanning(n_fft + 1)[:-1].astype(np.float32)


def stft_16(x: torch.Tensor, n_fft: int, hop: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """torch.stft(center=True, reflect) real / imag as DFT matmuls,
    [B, L] -> ([B, F, TT], [B, F, TT])."""
    fwd_r, fwd_i, _, _ = (c.to(x.device) for c in _dft_consts(n_fft))
    pad = n_fft // 2
    xp = F.pad(x[:, None], (pad, pad), mode="reflect")[:, 0]
    frames = xp.unfold(-1, n_fft, hop) * torch.from_numpy(_hann(n_fft)).to(x.device)
    return (frames @ fwd_r).transpose(1, 2), (frames @ fwd_i).transpose(1, 2)


def istft_16(mag: torch.Tensor, phase: torch.Tensor, n_fft: int, hop: int
             ) -> torch.Tensor:
    """torch.istft(center=True, hann window) as DFT matmuls + overlap-add:
    [B, F, TT] -> [B, (TT-1)*hop]."""
    _, _, inv_r, inv_i = (c.to(mag.device) for c in _dft_consts(n_fft))
    win = _hann(n_fft)
    real = (mag * torch.cos(phase)).transpose(1, 2)
    imag = (mag * torch.sin(phase)).transpose(1, 2)
    frames = (real @ inv_r + imag @ inv_i) * torch.from_numpy(win).to(mag.device)
    b, tt, _ = frames.shape
    out_len = n_fft + hop * (tt - 1)
    sig = None
    for j in range(n_fft // hop):
        g = frames[:, :, j * hop:(j + 1) * hop].reshape(b, tt * hop)
        part = F.pad(g, (j * hop, out_len - j * hop - tt * hop))
        sig = part if sig is None else sig + part
    pos = (np.arange(tt)[:, None] * hop + np.arange(n_fft)[None, :]).reshape(-1)
    wsum = np.zeros((out_len,), np.float32)
    np.add.at(wsum, pos, np.tile(win ** 2, tt))
    sig = sig / torch.from_numpy(np.maximum(wsum, 1e-8)).to(sig.device)
    pad = n_fft // 2
    return sig[:, pad:-pad] if pad else sig


class _SourceModule(nn.Module):
    def __init__(self, harmonics: int):
        super().__init__()
        self.l_linear = nn.Linear(harmonics + 1, 1)


class HiFTGenerator(nn.Module):
    """mel [B, T, n_mels] -> waveform [B, T*256].

    The convs compute in `dtype`; the f0, the sine source, the STFT, the
    magnitude/phase head and the iSTFT stay float32, as in JAX.  With
    `config.pallas_conv` the eligible ResBlock convs take the conv1d_same
    kernel."""

    def __init__(self, config: HiFTConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = self.config = config
        nfft = cfg.istft_n_fft
        self.f0_predictor = ConvRNNF0Predictor(cfg.f0_predictor_in_channels,
                                               cfg.f0_predictor_cond_channels)
        self.m_source = _SourceModule(cfg.nb_harmonics)
        self.conv_pre = WNConv(cfg.in_channels, cfg.base_channels, 7, padding=3)
        self.ups = nn.ModuleList()
        self.source_downs = nn.ModuleList()
        self.source_resblocks = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        downsample_rates = [1] + list(cfg.upsample_rates[::-1][:-1])
        down_cum = np.cumprod(downsample_rates)[::-1]
        for i, (u, k) in enumerate(zip(cfg.upsample_rates,
                                       cfg.upsample_kernel_sizes)):
            cin = cfg.base_channels // (2 ** i)
            ch = cfg.base_channels // (2 ** (i + 1))
            self.ups.append(WNConvTranspose(cin, ch, k, u, (k - u) // 2))
            u_i = int(down_cum[i])
            if u_i == 1:
                self.source_downs.append(WNConv(nfft + 2, ch, 1))
            else:
                self.source_downs.append(WNConv(nfft + 2, ch, u_i * 2,
                                                stride=u_i, padding=u_i // 2))
            self.source_resblocks.append(ResBlock(
                ch, cfg.source_resblock_kernel_sizes[i],
                cfg.source_resblock_dilation_sizes[i], cfg.pallas_conv))
            for k_r, d_r in zip(cfg.resblock_kernel_sizes,
                                cfg.resblock_dilation_sizes):
                self.resblocks.append(ResBlock(ch, k_r, d_r, cfg.pallas_conv))
        ch_last = cfg.base_channels // (2 ** len(cfg.upsample_rates))
        self.conv_post = WNConv(ch_last, nfft + 2, 7, padding=3)
        self.to(dtype)
        self.m_source.float()

    @property
    def dtype(self) -> torch.dtype:
        return self.conv_pre.weight.dtype

    def forward(self, mel: torch.Tensor, source_phase=None, source_noise=None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        cfg = self.config
        nfft, hop = cfg.istft_n_fft, cfg.istft_hop_len
        up_total = int(np.prod(cfg.upsample_rates)) * hop
        mel = mel.to(self.dtype)

        f0 = self.f0_predictor(mel).float()                   # [B, T]
        f0_up = torch.repeat_interleave(f0, up_total, dim=1)
        sines = sine_source(f0_up, cfg.sampling_rate, cfg.nb_harmonics,
                            cfg.nsf_alpha, cfg.nsf_sigma,
                            cfg.nsf_voiced_threshold, source_phase,
                            source_noise, generator)          # [B, H+1, Ts]
        merged = torch.tanh(self.m_source.l_linear(sines.transpose(1, 2)))[..., 0]
        s_real, s_imag = stft_16(merged, nfft, hop)
        s_stft = torch.cat([s_real, s_imag], dim=1).transpose(1, 2)
        s_stft = s_stft.to(self.dtype)                        # [B, TT, nfft+2]

        x = self.conv_pre(mel)
        num_up = len(cfg.upsample_rates)
        n_kernels = len(cfg.resblock_kernel_sizes)
        for i in range(num_up):
            x = F.leaky_relu(x, cfg.lrelu_slope)
            x = self.ups[i](x)
            if i == num_up - 1:
                x = torch.cat([x[:, 1:2], x], dim=1)          # reflection pad (1, 0)
            si = self.source_resblocks[i](self.source_downs[i](s_stft))
            x = x + si[:, : x.shape[1]]
            acc = None
            for j in range(n_kernels):
                r = self.resblocks[i * n_kernels + j](x)
                acc = r if acc is None else acc + r
            x = acc / n_kernels

        x = F.leaky_relu(x, 0.01)
        x = self.conv_post(x).float()
        mag = torch.clamp(torch.exp(x[..., : nfft // 2 + 1]), max=1e2).transpose(1, 2)
        phase = torch.sin(x[..., nfft // 2 + 1:]).transpose(1, 2)
        wav = istft_16(mag, phase, nfft, hop)
        return torch.clamp(wav, -cfg.audio_limit, cfg.audio_limit)
