# Frozen copy of taste_spokenlm_tpu_torch/models/flow.py at commit 1a9abc6: the plain path
# that the benchmark holds the port against.  Kernel, remat and
# data-parallel routes resolve to portbench/reference/stubs.py.
"""Flow-matching acoustic model: S3 speech tokens -> mel spectrogram
(counterpart of the JAX models/flow.py).

`MaskedDiffWithXvec.inference`: token embedding -> full-attention conformer
-> projection -> nearest length regulation + conv stack -> 10-step Euler
CFM whose estimator is the 1-D U-Net `ConditionalDecoder`, with the
conditional and unconditional (CFG) passes batched as one 2B call.

Public layouts follow JAX ([B, T, C] time-major); the convs run
channels-first inside.  Module names follow the CosyVoice flow state dict
(input_embedding, spk_embed_affine_layer, encoder.*, encoder_proj,
length_regulator.model.*, decoder.estimator.*).  With
`FlowConfig.fused_dit_serving` each U-Net transformer block takes the
`fused_dit_block` kernel under the JAX gate, but never where autograd
records for its weights or input: the kernel has no backward (in either
package), so training takes the unfused blocks.  The CFM start noise `z`
is drawn from a `torch.Generator` or passed in.

Training (`MaskedDiffWithXvec.forward`, `ConditionalCFM.compute_loss`):
the OT-CFM loss, a masked MSE between the estimator's velocity at a random
time t on the straight path from noise z to the target mel and the path's
velocity, with the conditions dropped per row at `training_cfg_rate`.  Its
draws (t, z, keep) are passed in or taken from a generator.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from portbench.reference.config import FlowConfig
from portbench.reference.stubs import (
    can_use_fused_dit, fused_dit_block, fused_dit_block_plain)
from portbench.reference.conformer import ConformerEncoder
from portbench.reference.attention import multi_head_attention
from portbench.reference.masking import length_mask
from portbench.reference import stubs as mesh


def nearest_interpolate(x: torch.Tensor, out_len: int, in_lengths: torch.Tensor,
                        out_lengths: torch.Tensor) -> torch.Tensor:
    """[B, T, C] -> [B, out_len, C]: frame i of sample b reads token
    floor(i * in_len[b] / out_len[b])."""
    t = x.shape[1]
    frames = torch.arange(out_len, device=x.device)[None, :]
    idx = (frames * in_lengths[:, None]) // torch.clamp(out_lengths[:, None], min=1)
    idx = torch.clamp(idx, 0, t - 1)
    return torch.gather(x, 1, idx[:, :, None].expand(-1, -1, x.shape[-1]))


class InterpolateRegulator(nn.Module):
    """Nearest-interpolate to mel frames, then 4x [Conv k3 + GroupNorm(1) +
    Mish] + a 1x1 conv, masked to the mel lengths."""

    def __init__(self, channels: int, n_layers: int = 4):
        super().__init__()
        layers = []
        for _ in range(n_layers):
            layers += [nn.Conv1d(channels, channels, 3, padding=1),
                       nn.GroupNorm(1, channels, eps=1e-5), nn.Mish()]
        layers.append(nn.Conv1d(channels, channels, 1))
        self.model = nn.Sequential(*layers)

    def forward(self, x, out_len: int, out_lengths, in_lengths):
        h = nearest_interpolate(x, out_len, in_lengths, out_lengths)
        h = self.model(h.transpose(1, 2)).transpose(1, 2)
        return h * length_mask(out_lengths, out_len)[:, :, None].to(h.dtype)


class Block1D(nn.Module):
    def __init__(self, dim: int, dim_out: int, groups: int = 8):
        super().__init__()
        self.block = nn.Sequential(nn.Conv1d(dim, dim_out, 3, padding=1),
                                   nn.GroupNorm(groups, dim_out, eps=1e-5),
                                   nn.Mish())

    def forward(self, x, mask):
        """x [B, C, T]; mask [B, 1, T]."""
        return self.block(x * mask) * mask


class ResnetBlock1D(nn.Module):
    def __init__(self, dim: int, dim_out: int, time_emb_dim: int,
                 groups: int = 8):
        super().__init__()
        self.mlp = nn.Sequential(nn.Mish(), nn.Linear(time_emb_dim, dim_out))
        self.block1 = Block1D(dim, dim_out, groups)
        self.block2 = Block1D(dim_out, dim_out, groups)
        self.res_conv = nn.Conv1d(dim, dim_out, 1)

    def forward(self, x, mask, t_emb):
        h = self.block1(x, mask)
        h = h + self.mlp(t_emb)[:, :, None]
        h = self.block2(h, mask)
        return h + self.res_conv(x * mask)


class DiffusersAttention(nn.Module):
    """diffusers-style self-attention: to_q/k/v without bias, to_out.0."""

    def __init__(self, dim: int, heads: int, head_dim: int):
        super().__init__()
        inner = heads * head_dim
        self.heads, self.head_dim = heads, head_dim
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_k = nn.Linear(dim, inner, bias=False)
        self.to_v = nn.Linear(dim, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, dim), nn.Dropout(0.0)])

    def forward(self, x, key_valid=None):
        b, t, _ = x.shape
        shape = (b, t, self.heads, self.head_dim)
        q, k, v = (p(x).view(shape) for p in (self.to_q, self.to_k, self.to_v))
        mask = None if key_valid is None else key_valid[:, None, None, :]
        out = multi_head_attention(q, k, v, mask=mask)
        return self.to_out[0](out.reshape(b, t, -1))


class _GELUProj(nn.Module):
    def __init__(self, dim: int, dim_out: int):
        super().__init__()
        self.proj = nn.Linear(dim, dim_out)

    def forward(self, x):
        return F.gelu(self.proj(x))


class _FeedForward(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.net = nn.ModuleList([_GELUProj(dim, 4 * dim), nn.Dropout(0.0),
                                  nn.Linear(4 * dim, dim)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


class BasicTransformerBlock(nn.Module):
    """LayerNorm -> self-attention (+res) -> LayerNorm -> 4x GELU MLP (+res)
    on [B, T, C].

    With `fused`, a call with key validity whose shape passes
    `can_use_fused_dit` takes the fused_dit_block kernel (the JAX gate),
    unless autograd records for the input or any weight.  The kernel's
    [in, out] weight layout is a cache of the live weights: it is made
    again whenever one of them has been written since (a state-dict load,
    an optimizer step, a move to another device)."""

    def __init__(self, dim: int, heads: int, head_dim: int, fused: bool = False):
        super().__init__()
        self.dim, self.heads, self.head_dim, self.fused = dim, heads, head_dim, fused
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = DiffusersAttention(dim, heads, head_dim)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = _FeedForward(dim)
        self.use_kernels = True
        self._kernel_key = None
        if fused:
            for name, w in self._kernel_weights().items():
                self.register_buffer(name, w, persistent=False)

    def _kernel_linears(self) -> Dict[str, nn.Linear]:
        return {"wq": self.attn1.to_q, "wk": self.attn1.to_k,
                "wv": self.attn1.to_v, "wo": self.attn1.to_out[0],
                "w1": self.ff.net[0].proj, "w2": self.ff.net[2]}

    def _weights_key(self) -> tuple:
        # an in-place write bumps a weight's version counter, a move
        # changes its storage
        return tuple((m.weight.data_ptr(), m.weight._version)
                     for m in self._kernel_linears().values())

    def _kernel_weights(self) -> Dict[str, torch.Tensor]:
        self._kernel_key = self._weights_key()
        return {f"kernel_{n}": m.weight.detach().t().contiguous()
                for n, m in self._kernel_linears().items()}

    def refresh_kernel_weights(self) -> None:
        """Remake the kernel layout if a weight was written since."""
        if self._weights_key() != self._kernel_key:
            for name, w in self._kernel_weights().items():
                setattr(self, name, w)

    def fused_params(self) -> Dict:
        """The block's weights in the JAX param-tree layout that
        fused_dit_block takes (kernels [in, out])."""
        self.refresh_kernel_weights()
        return {
            "norm1": {"scale": self.norm1.weight, "bias": self.norm1.bias},
            "attn1": {"to_q": {"kernel": self.kernel_wq},
                      "to_k": {"kernel": self.kernel_wk},
                      "to_v": {"kernel": self.kernel_wv},
                      "to_out": {"kernel": self.kernel_wo,
                                 "bias": self.attn1.to_out[0].bias}},
            "norm3": {"scale": self.norm3.weight, "bias": self.norm3.bias},
            "ff_in": {"kernel": self.kernel_w1, "bias": self.ff.net[0].proj.bias},
            "ff_out": {"kernel": self.kernel_w2, "bias": self.ff.net[2].bias},
        }

    def forward(self, x, key_valid=None):
        grad = torch.is_grad_enabled() and (
            x.requires_grad or any(p.requires_grad for p in self.parameters()))
        if (self.fused and key_valid is not None and not grad
                and can_use_fused_dit(x.shape[1], self.dim,
                                      self.heads * self.head_dim)):
            block = fused_dit_block if self.use_kernels else fused_dit_block_plain
            lengths = key_valid.sum(dim=-1).to(torch.int32)
            return block(x.contiguous(), lengths, self.fused_params(),
                         heads=self.heads, head_dim=self.head_dim)
        x = x + self.attn1(self.norm1(x), key_valid=key_valid)
        return x + self.ff(self.norm3(x))


def sinusoidal_time_emb(t: torch.Tensor, dim: int, scale: float = 1000.0
                        ) -> torch.Tensor:
    """matcha SinusoidalPosEmb: [B] -> [B, dim]."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) / (half - 1)
                      * torch.arange(half, dtype=torch.float32, device=t.device))
    ang = scale * t[:, None] * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


class _TimeMLP(nn.Module):
    def __init__(self, in_dim: int, time_dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, time_dim)
        self.linear_2 = nn.Linear(time_dim, time_dim)

    def forward(self, t_emb):
        return self.linear_2(F.silu(self.linear_1(t_emb)))


class _Downsample1D(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.conv = nn.Conv1d(dim, dim, 3, stride=2, padding=1)

    def forward(self, x):
        return self.conv(x)


class _Upsample1D(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.conv = nn.ConvTranspose1d(dim, dim, 4, stride=2, padding=1)

    def forward(self, x):
        return self.conv(x)


class ConditionalDecoder(nn.Module):
    """1-D U-Net CFM estimator.  Each of down_blocks / mid_blocks /
    up_blocks.{i} is [resnet, transformer blocks, (down|up)sample]."""

    def __init__(self, config: FlowConfig):
        super().__init__()
        cfg = self.config = config
        channels = cfg.estimator_channels
        n_mels = cfg.output_size
        in_ch = n_mels * 4                      # x, mu, spks, cond
        time_dim = channels[0] * 4
        self.in_ch = in_ch
        self.time_mlp = _TimeMLP(in_ch, time_dim)

        def tf_stack(ch):
            return nn.ModuleList(
                BasicTransformerBlock(ch, cfg.estimator_num_heads,
                                      cfg.estimator_attention_head_dim,
                                      fused=cfg.fused_dit_serving)
                for _ in range(cfg.estimator_n_blocks))

        self.down_blocks = nn.ModuleList()
        out_ch = in_ch
        for i, ch in enumerate(channels):
            is_last = i == len(channels) - 1
            down = (nn.Conv1d(ch, ch, 3, padding=1) if is_last
                    else _Downsample1D(ch))
            self.down_blocks.append(nn.ModuleList(
                [ResnetBlock1D(out_ch, ch, time_dim), tf_stack(ch), down]))
            out_ch = ch
        self.mid_blocks = nn.ModuleList(
            nn.ModuleList([ResnetBlock1D(channels[-1], channels[-1], time_dim),
                           tf_stack(channels[-1])])
            for _ in range(cfg.estimator_num_mid_blocks))
        rev = tuple(channels[::-1]) + (channels[0],)
        self.up_blocks = nn.ModuleList()
        for i in range(len(rev) - 1):
            out_ch = rev[i + 1]
            is_last = i == len(rev) - 2
            up = (nn.Conv1d(out_ch, out_ch, 3, padding=1) if is_last
                  else _Upsample1D(out_ch))
            self.up_blocks.append(nn.ModuleList(
                [ResnetBlock1D(2 * rev[i], out_ch, time_dim), tf_stack(out_ch),
                 up]))
        self.final_block = Block1D(rev[-1], rev[-1])
        self.final_proj = nn.Conv1d(rev[-1], n_mels, 1)

    @property
    def dtype(self) -> torch.dtype:
        return self.final_proj.weight.dtype

    def forward(self, x, mask, mu, t, spks, cond):
        """x/mu/cond [B, T, n_mels]; mask bool [B, T]; t [B]; spks
        [B, n_mels] -> velocity [B, T, n_mels]."""
        t_emb = sinusoidal_time_emb(t.float(), self.in_ch).to(x.dtype)
        t_emb = self.time_mlp(t_emb)
        spk = spks[:, None, :].expand(-1, x.shape[1], -1)
        h = torch.cat([x, mu, spk, cond], dim=-1).transpose(1, 2)   # [B, C, T]
        m0 = mask.to(h.dtype)[:, None, :]                            # [B, 1, T]

        def tf_stack(blocks, h, m):
            kv = m[:, 0, :] > 0.5
            h = h.transpose(1, 2)
            for blk in blocks:
                h = blk(h, kv)
            return h.transpose(1, 2)

        masks, skips = [m0], []
        for i, (resnet, blocks, down) in enumerate(self.down_blocks):
            m = masks[-1]
            h = tf_stack(blocks, resnet(h, m, t_emb), m)
            skips.append(h)
            h = down(h * m)
            masks.append(m if i == len(self.down_blocks) - 1 else m[:, :, ::2])
        masks = masks[:-1]
        m_mid = masks[-1]
        for resnet, blocks in self.mid_blocks:
            h = tf_stack(blocks, resnet(h, m_mid, t_emb), m_mid)
        for resnet, blocks, up in self.up_blocks:
            m = masks.pop()
            skip = skips.pop()
            h = torch.cat([h[:, :, : skip.shape[2]], skip], dim=1)
            h = tf_stack(blocks, resnet(h, m, t_emb), m)
            h = up(h * m)
            m_final = m
        h = h[:, :, : m_final.shape[2]]
        h = self.final_block(h, m_final)
        out = self.final_proj(h * m_final) * m_final
        return out.transpose(1, 2)


class ConditionalCFM(nn.Module):
    """Euler ODE solve of the OT-CFM with batched classifier-free guidance.
    The ODE state and the Euler update stay float32; the estimator computes
    in its own dtype."""

    def __init__(self, config: FlowConfig):
        super().__init__()
        self.config = config
        self.estimator = ConditionalDecoder(config)

    def forward(self, mu, mask, spks, cond, n_timesteps: Optional[int] = None,
                temperature: float = 1.0, z: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """mu/cond [B, T, M]; mask bool [B, T]; spks [B, M].  `z` [B, T, M]
        is the start noise (standard normal draws from `generator` when not
        given)."""
        cfg = self.config
        n = n_timesteps or cfg.n_timesteps
        dev = mu.device
        if z is None:
            z = torch.randn(mu.shape, generator=generator, device=dev) * temperature
        t_span = torch.linspace(0.0, 1.0, n + 1, device=dev)
        if cfg.t_scheduler == "cosine":
            t_span = 1.0 - torch.cos(t_span * 0.5 * math.pi)
        cfg_rate = cfg.inference_cfg_rate
        b = mu.shape[0]
        cdt = self.estimator.dtype
        mu_c, spks_c, cond_c = mu.to(cdt), spks.to(cdt), cond.to(cdt)
        if cfg_rate > 0:
            mu_c = torch.cat([mu_c, torch.zeros_like(mu_c)])
            spks_c = torch.cat([spks_c, torch.zeros_like(spks_c)])
            cond_c = torch.cat([cond_c, torch.zeros_like(cond_c)])
            mask = torch.cat([mask, mask])
        x = z.to(dev, torch.float32)
        for i in range(n):
            t, dt = t_span[i], t_span[i + 1] - t_span[i]
            xc = x.to(cdt)
            if cfg_rate > 0:
                v2 = self.estimator(torch.cat([xc, xc]), mask, mu_c,
                                    t.expand(2 * b), spks_c, cond_c).float()
                v = (1.0 + cfg_rate) * v2[:b] - cfg_rate * v2[b:]
            else:
                v = self.estimator(xc, mask, mu_c, t.expand(b), spks_c,
                                   cond_c).float()
            x = x + dt * v
        return x

    def compute_loss(self, x1, mask, mu, spks, cond,
                     t: Optional[torch.Tensor] = None,
                     z: Optional[torch.Tensor] = None,
                     keep: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None):
        """The OT-CFM training loss.  x1 (the target mel) / mu / cond
        [B, T, M]; mask bool [B, T]; spks [B, M].  Draws: `t` [B] uniform
        in [0, 1) (before the cosine scheduler), `z` [B, T, M] standard
        normal, `keep` bool [B] (the rows whose conditions stay, used when
        `training_cfg_rate` > 0); each from `generator` when not given."""
        cfg = self.config
        b, dev = x1.shape[0], x1.device
        if t is None:
            t = mesh.draw_rows(lambda s: torch.rand(
                s, generator=generator, device=dev), (b,))
        if z is None:
            z = mesh.draw_rows(lambda s: torch.randn(
                s, generator=generator, device=dev), x1.shape)
        t = t.to(dev, torch.float32)[:, None, None]
        if cfg.t_scheduler == "cosine":
            t = 1.0 - torch.cos(t * 0.5 * math.pi)
        z = z.to(dev, torch.float32)
        y = (1.0 - (1.0 - cfg.sigma_min) * t) * z + t * x1
        u = x1 - (1.0 - cfg.sigma_min) * z
        if cfg.training_cfg_rate > 0:
            if keep is None:
                keep = mesh.draw_rows(lambda s: torch.rand(
                    s, generator=generator, device=dev), (b,)
                ) > cfg.training_cfg_rate
            k = keep.to(dev, torch.float32)
            mu, spks, cond = mu * k[:, None, None], spks * k[:, None], \
                cond * k[:, None, None]
        cdt = self.estimator.dtype
        pred = self.estimator(y.to(cdt), mask, mu.to(cdt), t[:, 0, 0],
                              spks.to(cdt), cond.to(cdt)).float()
        maskf = mask.float()[:, :, None]
        return (((pred - u) ** 2 * maskf).sum()
                / (mesh.global_sum(maskf.sum()) * x1.shape[-1]))


class MaskedDiffWithXvec(nn.Module):
    """Token -> mel flow model.  The conformer encoder and the CFM estimator
    compute in `dtype`; the embeddings, projections and length regulator
    stay float32."""

    def __init__(self, config: FlowConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = self.config = config
        self.input_embedding = nn.Embedding(cfg.vocab_size, cfg.input_size)
        self.spk_embed_affine_layer = nn.Linear(cfg.spk_embed_dim, cfg.output_size)
        self.encoder = ConformerEncoder(cfg.encoder).to(dtype)
        self.encoder_proj = nn.Linear(cfg.encoder.output_size, cfg.output_size)
        self.length_regulator = InterpolateRegulator(cfg.output_size)
        self.decoder = ConditionalCFM(cfg)
        self.decoder.estimator.to(dtype)

    def mel_lengths(self, token_len: torch.Tensor) -> torch.Tensor:
        """Token count -> mel frame count: len/50 * 22050/256."""
        return (token_len.float() / self.config.input_frame_rate
                * 22050.0 / 256.0).to(torch.int64)

    def _speaker(self, embedding):
        emb32 = embedding.float()
        spk = emb32 / torch.clamp(torch.linalg.norm(emb32, dim=-1, keepdim=True),
                                  min=1e-8)
        return self.spk_embed_affine_layer(spk)

    def _encode(self, token, token_len, mel_len_max: int, mel_lengths):
        """Tokens -> the conditioning mu [B, mel_len_max, M]."""
        mask = length_mask(token_len, token.shape[1])
        emb = self.input_embedding(torch.clamp(token, min=0)) * mask[:, :, None]
        h = self.encoder(emb, token_len, causal=False)
        h = self.encoder_proj(h.float())
        return self.length_regulator(h, mel_len_max, mel_lengths, token_len)

    def forward(self, token, token_len, feat, feat_len, embedding,
                generator: Optional[torch.Generator] = None,
                t: Optional[torch.Tensor] = None,
                z: Optional[torch.Tensor] = None,
                keep: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """The training loss: token [B, T] and the target mel feat
        [B, Tm, M] (ops/audio.flow_mel) with its lengths -> {"loss"}.  The
        CFM's draws as ConditionalCFM.compute_loss takes them."""
        spk = self._speaker(embedding)
        h = self._encode(token, token_len, feat.shape[1], feat_len)
        mask = length_mask(feat_len, feat.shape[1])
        loss = self.decoder.compute_loss(feat.float(), mask, h, spk,
                                         torch.zeros_like(feat, dtype=torch.float32),
                                         t=t, z=z, keep=keep,
                                         generator=generator)
        return {"loss": loss}

    @torch.no_grad()
    def inference(self, token, token_len, embedding, mel_len_max: int,
                  n_timesteps: Optional[int] = None,
                  z: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None):
        """token [B, T] -> (mel [B, mel_len_max, M] masked beyond its length,
        mel lengths [B])."""
        spk = self._speaker(embedding)
        mel_lengths = torch.clamp(self.mel_lengths(token_len), max=mel_len_max)
        h = self._encode(token, token_len, mel_len_max, mel_lengths)
        conds = torch.zeros((token.shape[0], mel_len_max, self.config.output_size),
                            device=token.device)
        mel_mask = length_mask(mel_lengths, mel_len_max)
        mel = self.decoder(h, mel_mask, spk, conds, n_timesteps, z=z,
                           generator=generator)
        return mel * mel_mask[:, :, None], mel_lengths
