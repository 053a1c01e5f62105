# Frozen copy of taste_spokenlm_tpu_torch/models/conformer.py at commit 1a9abc6: the plain path
# that the benchmark holds the port against.  Kernel, remat and
# data-parallel routes resolve to portbench/reference/stubs.py.
"""ESPnet/WeNet-style transformer encoder stack with relative-position
attention (counterpart of the JAX models/conformer.py).

Ported: `RelPositionAttention` (full sequence and cached decode, with
precomputed position projections), the positionwise FFN, and
`ConformerEncoder` with the `linear` / `linear_legacy` input layers, in the
float layout and the int8 / int4 serving layouts of EncoderStackConfig:
`quantized_serving` (QDense / QDense4 projections), `fused_qkv_serving`
(one linear_qkv) and `fused_mlp_serving` (the FFN as one kernel call,
kernels/fused_mlp.py; int4 packs w_2 per tile).  A strict-causal
full-sequence pass (`causal_scores`, no cache, Tq == Tk > 1) of T >= 256 with
a head dim of 128 on a CUDA tensor runs the rel-pos attention kernel,
forward and backward (kernels/relpos_attention.py), where the JAX package
takes its Pallas kernel on the TPU: the S3 stack's stage-1 training pass,
and the text and audio encoders on a long transcript.  Everything else,
and every CPU tensor, takes the JAX package's non-kernel branch.  With
`remat` set in the stack's config, each layer is checkpointed
(ops/remat.py).  The conformer options of the config run in the
full-sequence forward: the convolution module (`use_cnn_module`: GLU,
depthwise conv with causal or centred padding, BatchNorm or LayerNorm),
the macaron FFN and the conv subsampling stems (`input_layer` conv1d2,
conv2d, conv2d4, conv2d6, conv2d8, with the reference's length mapping);
the cached decode takes neither the conv module nor a stem, as in JAX.

Names follow the reference state dict: embed.out.{0,1} (or the stems'
embed.conv.{0,2,4} and embed.out.0 / embed.linear), encoders.{i}.
self_attn.linear_{q,k,v,out,pos} (or linear_qkv), pos_bias_u/v,
feed_forward.w_1/w_2, feed_forward_macaron, conv_module.{pointwise_conv1,
depthwise_conv, norm, pointwise_conv2}, norm_mha/norm_ff (or norm1/norm2
for linear_legacy), norm_ff_macaron, norm_conv, norm_final, after_norm; a
QDense holds kernel_q [in, out], scale and bias, a QDense4 kernel_q4
[in/2, out], scale [in/g, out] and bias.  Decode caches are written in
place.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from portbench.reference.config import EncoderStackConfig
from portbench.reference.stubs import (
    can_use_relpos_flash, relpos_causal_attention)
from portbench.reference.masking import chunk_causal_mask, length_mask
from portbench.reference.stubs import (dense, fused_ffn_apply,
                                                    qmode)
from portbench.reference.stubs import call_layer

NEG_F32 = torch.finfo(torch.float32).min / 2

_ACT = {
    "relu": F.relu,
    "swish": F.silu,
    "gelu": F.gelu,
    "tanh": torch.tanh,
}


def espnet_rel_pos_table(d_model: int, max_len: int) -> np.ndarray:
    """Relative-position sinusoids, 2*max_len-1 rows; row p encodes
    rel = (max_len-1) - p (positive rels first)."""
    pos = np.arange(max_len, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float64)
                 * -(math.log(10000.0) / d_model))
    pe_pos = np.zeros((max_len, d_model))
    pe_pos[:, 0::2] = np.sin(pos * div)
    pe_pos[:, 1::2] = np.cos(pos * div)
    pe_neg = np.zeros((max_len, d_model))
    pe_neg[:, 0::2] = np.sin(-pos * div)
    pe_neg[:, 1::2] = np.cos(-pos * div)
    return np.concatenate([pe_pos[::-1], pe_neg[1:]], axis=0).astype(np.float32)


def rel_shift(x: torch.Tensor) -> torch.Tensor:
    """[B, H, T, 2T-1] -> [B, H, T, T]: out[..., i, j] = x[..., i, (T-1)-i+j]."""
    b, h, t, _ = x.shape
    x = F.pad(x, (1, 0))
    x = x.reshape(b, h, 2 * t, t)[:, :, 1:]
    return x.reshape(b, h, t, 2 * t - 1)[..., :t]


class RelPositionAttention(nn.Module):
    """scores = ((q + u) k^T + rel_shift((q + v) p^T)) / sqrt(dk).

    `use_kernels = False` keeps a CUDA tensor on the non-kernel branch, to
    hold the kernel path against the plain one."""

    def __init__(self, d_model: int, num_heads: int, quantized=False,
                 fused_qkv: bool = False):
        super().__init__()
        self.d_model, self.num_heads = d_model, num_heads
        self.fused_qkv = fused_qkv
        dk = d_model // num_heads
        d = d_model
        if fused_qkv:
            self.linear_qkv = dense(d, 3 * d, quantized)
        else:
            self.linear_q = dense(d, d, quantized)
            self.linear_k = dense(d, d, quantized)
            self.linear_v = dense(d, d, quantized)
        self.linear_out = dense(d, d, quantized)
        self.linear_pos = dense(d, d, quantized, use_bias=False)
        self.pos_bias_u = nn.Parameter(torch.zeros(num_heads, dk))
        self.pos_bias_v = nn.Parameter(torch.zeros(num_heads, dk))
        nn.init.xavier_uniform_(self.pos_bias_u)
        nn.init.xavier_uniform_(self.pos_bias_v)
        self.use_kernels = True

    def forward(self, x, pos_emb, mask=None,
                cache: Optional[Dict[str, torch.Tensor]] = None,
                cache_index: int = 0, pos_proj=None,
                causal_scores: bool = False):
        """x [B, T, C]; pos_emb [Tq+Tk-1, C]; mask bool [B, 1, Tq, Tk]."""
        b, t, _ = x.shape
        h, dk = self.num_heads, self.d_model // self.num_heads
        dt = x.dtype
        if self.fused_qkv:
            q, k, v = (z.reshape(b, t, h, dk)
                       for z in self.linear_qkv(x).chunk(3, dim=-1))
        else:
            q = self.linear_q(x).view(b, t, h, dk)
            k = self.linear_k(x).view(b, t, h, dk)
            v = self.linear_v(x).view(b, t, h, dk)
        if cache is not None:
            cache["k"][:, cache_index:cache_index + t] = k
            cache["v"][:, cache_index:cache_index + t] = v
            k, v = cache["k"], cache["v"]
        if pos_proj is None:
            pos_proj = self.linear_pos(pos_emb)
        tk, tq = k.shape[1], t
        if pos_proj.shape[0] != tq + tk - 1:
            raise ValueError(f"pos_emb rows {pos_proj.shape[0]} != Tq + Tk - 1"
                             f" = {tq + tk - 1}")
        strict_causal = causal_scores and cache is None and tq == tk and tq > 1
        if (strict_causal and self.use_kernels and x.is_cuda
                and can_use_relpos_flash(tq, dk)):
            # the causal_scores contract: mask = strict causal and key-valid,
            # so its last row carries each row's key count
            lengths = (None if mask is None else mask[:, 0, -1, :].sum(-1)
                       .to(torch.int32).expand(b).contiguous())
            out = relpos_causal_attention(
                (q + self.pos_bias_u[None, None]).contiguous(),
                (q + self.pos_bias_v[None, None]).contiguous(),
                k.contiguous(), v.contiguous(),
                pos_proj.reshape(-1, h, dk).contiguous(), lengths)
            return self.linear_out(out.reshape(b, t, self.d_model)), cache
        p = pos_proj.reshape(-1, h, dk).float()
        q_u = (q + self.pos_bias_u[None, None]).float()
        q_v = (q + self.pos_bias_v[None, None]).float()
        if strict_causal:
            # strict-causal scores never read the future half of the table:
            # q_v p[:T]^T stored in the model dtype, then the pad-left-1 skew
            bd = torch.einsum("bqhd,phd->bhqp", q_v, p[:tq]).to(dt)
            bd = F.pad(bd, (1, 0)).reshape(b, h, tq * (tq + 1))
            bd = bd.reshape(b, h, tq + 1, tq)[:, :, 1:].float()
        elif tq == tk:
            bd = rel_shift(torch.einsum("bqhd,phd->bhqp", q_v, p))
        elif tq > 1:
            bd = torch.einsum("bqhd,phd->bhqp", q_v, p)
            idx = ((tq - 1 - torch.arange(tq, device=x.device))[:, None]
                   + torch.arange(tk, device=x.device)[None, :])
            bd = torch.gather(bd, 3, idx[None, None].expand(b, h, tq, tk))
        else:
            bd = torch.einsum("bqhd,phd->bhqp", q_v, p)
        ac = torch.einsum("bqhd,bkhd->bhqk", q_u, k.float())
        scores = (ac + bd) * (1.0 / math.sqrt(dk))
        if mask is not None:
            scores = torch.where(mask, scores, scores.new_tensor(NEG_F32))
        probs = torch.softmax(scores, dim=-1).to(dt)
        out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float()).to(dt)
        return self.linear_out(out.reshape(b, t, self.d_model)), cache


class PositionwiseFeedForward(nn.Module):
    """w_2(act(w_1 x)); with `fused` and a quantized layout, one
    fused_ffn_apply over the two QDense / QDense4 weights (the kernel's plain
    version when `use_kernels` is False)."""

    def __init__(self, d_model: int, hidden: int, activation: str = "relu",
                 quantized=False, fused: bool = False):
        super().__init__()
        self.w_1 = dense(d_model, hidden, quantized)
        self.w_2 = dense(hidden, d_model, quantized)
        self.activation, self.act = activation, _ACT[activation]
        self.mode = qmode(quantized)
        self.fused = fused and self.mode is not None
        self.use_kernels = True

    def forward(self, x):
        if self.fused:
            w = "kernel_q4" if self.mode == "int4" else "kernel_q"
            triple = lambda m: (getattr(m, w), m.scale, m.bias)  # noqa: E731
            return fused_ffn_apply(x, triple(self.w_1), triple(self.w_2),
                                   self.mode, x.dtype, self.activation,
                                   self.use_kernels)
        return self.w_2(self.act(self.w_1(x)))


class FlaxBatchNorm(nn.Module):
    """BatchNorm over [B, T, C] with flax's arithmetic: train mode
    normalises with the batch's mean and biased variance (E[x^2] - E[x]^2,
    clipped at 0, over every row, padding included) and moves the running
    statistics as flax's `batch_stats` do, r = 0.99 r + 0.01 s (torch's
    momentum 0.01) with the biased variance; eval mode reads them.  State
    dict: weight, bias, running_mean, running_var, num_batches_tracked."""

    def __init__(self, channels: int, eps: float = 1e-5,
                 momentum: float = 0.99):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.long))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if train:
            xf = x.float().reshape(-1, x.shape[-1])
            mean = xf.mean(dim=0)
            var = torch.clamp((xf * xf).mean(dim=0) - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean.float()
                                        + (1 - m) * mean.detach())
                self.running_var.copy_(m * self.running_var.float()
                                       + (1 - m) * var.detach())
                self.num_batches_tracked += 1
        else:
            mean, var = self.running_mean.float(), self.running_var.float()
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        return ((x.float() - mean) * mul + self.bias.float()).to(x.dtype)


class ConvolutionModule(nn.Module):
    """Pointwise conv -> GLU -> depthwise conv -> norm -> activation ->
    pointwise conv, on [B, T, C], padded frames zeroed at the input and at
    the output.  Causal mode left-pads the raw input by k - 1 before the
    first pointwise conv (so its bias reaches the window's left edge, as
    in the reference); otherwise the GLU output is zero-padded by
    (k - 1) / 2 on both sides."""

    def __init__(self, channels: int, kernel_size: int = 15,
                 activation: str = "swish", norm_type: str = "batch_norm",
                 causal: bool = False):
        super().__init__()
        self.kernel_size, self.causal, self.norm_type = (kernel_size, causal,
                                                         norm_type)
        self.act = _ACT[activation]
        self.pointwise_conv1 = nn.Conv1d(channels, 2 * channels, 1)
        self.depthwise_conv = nn.Conv1d(channels, channels, kernel_size,
                                        groups=channels)
        self.norm = (nn.LayerNorm(channels, eps=1e-5)
                     if norm_type == "layer_norm" else FlaxBatchNorm(channels))
        self.pointwise_conv2 = nn.Conv1d(channels, channels, 1)

    def forward(self, x, pad_mask=None, train: bool = False):
        if pad_mask is not None:
            x = x * pad_mask[..., None].to(x.dtype)
        y = x.transpose(1, 2)                                  # [B, C, T]
        if self.causal:
            y = F.pad(y, (self.kernel_size - 1, 0))
        a, g = self.pointwise_conv1(y).chunk(2, dim=1)
        y = a * torch.sigmoid(g)
        if not self.causal:
            half = (self.kernel_size - 1) // 2
            y = F.pad(y, (half, half))
        y = self.depthwise_conv(y).transpose(1, 2)             # [B, T, C]
        y = (self.norm(y) if self.norm_type == "layer_norm"
             else self.norm(y, train))
        y = self.pointwise_conv2(self.act(y).transpose(1, 2)).transpose(1, 2)
        if pad_mask is not None:
            y = y * pad_mask[..., None].to(y.dtype)
        return y


class EncoderLayer(nn.Module):
    """Pre-LN (macaron FFN ->) MHA (-> conv module) -> FFN layer (and a
    final LayerNorm with the conv module); `conformer_names` picks
    norm_mha/norm_ff (else norm1/norm2), as the reference state dicts
    do."""

    def __init__(self, d_model: int, num_heads: int, ffn_dim: int,
                 activation: str, conformer_names: bool = True,
                 quantized=False, fused_qkv: bool = False,
                 fused_mlp: bool = False, macaron_style: bool = False,
                 use_cnn_module: bool = False, cnn_module_kernel: int = 15,
                 cnn_module_norm: str = "batch_norm",
                 cnn_causal: bool = False):
        super().__init__()
        self.self_attn = RelPositionAttention(d_model, num_heads, quantized,
                                              fused_qkv)
        self.feed_forward = PositionwiseFeedForward(d_model, ffn_dim, activation,
                                                    quantized, fused_mlp)
        self.mha_norm_name = "norm_mha" if conformer_names else "norm1"
        self.ff_norm_name = "norm_ff" if conformer_names else "norm2"
        setattr(self, self.mha_norm_name, nn.LayerNorm(d_model, eps=1e-5))
        setattr(self, self.ff_norm_name, nn.LayerNorm(d_model, eps=1e-5))
        self.macaron, self.use_cnn = macaron_style, use_cnn_module
        self.ff_scale = 0.5 if macaron_style else 1.0
        if macaron_style:
            self.feed_forward_macaron = PositionwiseFeedForward(
                d_model, ffn_dim, activation, quantized, fused_mlp)
            self.norm_ff_macaron = nn.LayerNorm(d_model, eps=1e-5)
        if use_cnn_module:
            self.conv_module = ConvolutionModule(
                d_model, cnn_module_kernel, activation, cnn_module_norm,
                cnn_causal)
            self.norm_conv = nn.LayerNorm(d_model, eps=1e-5)
            self.norm_final = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, x, pos_emb, mask=None, cache=None, cache_index: int = 0,
                pos_proj=None, causal_scores: bool = False, pad_mask=None,
                train: bool = False):
        if self.macaron:
            x = x + self.ff_scale * self.feed_forward_macaron(
                self.norm_ff_macaron(x))
        h, new_cache = self.self_attn(
            getattr(self, self.mha_norm_name)(x), pos_emb, mask=mask,
            cache=cache, cache_index=cache_index, pos_proj=pos_proj,
            causal_scores=causal_scores)
        x = x + h
        if self.use_cnn:
            x = x + self.conv_module(self.norm_conv(x), pad_mask, train)
        h = self.feed_forward(getattr(self, self.ff_norm_name)(x))
        x = x + (self.ff_scale * h if self.macaron else h)
        if self.use_cnn:
            x = self.norm_final(x)
        return x, new_cache


_CONV2D = {"conv2d": (3, 2), "conv2d4": (3, 2), "conv2d6": (5, 3),
           "conv2d8": (3, 2)}   # the second conv's kernel and stride


class _Embed(nn.Module):
    """The input layer: Linear -> LayerNorm (`out`), or a conv stem:
    conv1d2 (`conv` = two Conv1d, GELU each, the second stride 2) or the
    conv2d stems (`conv` = 3x3 stride-2 VALID Conv2d, ReLU, then 3x3 / 5x5
    stride 2 / 3 (and, in conv2d8, a third 3x3 stride 2), each ReLU;
    then `out.0` (conv2d, conv2d4) or `linear` over the (channel,
    frequency) flatten)."""

    def __init__(self, layer: str, input_size: int, output_size: int):
        super().__init__()
        self.layer = layer
        if layer in ("linear", "linear_legacy"):
            self.out = nn.Sequential(nn.Linear(input_size, output_size),
                                     nn.LayerNorm(output_size, eps=1e-5))
        elif layer == "conv1d2":
            self.conv = nn.Sequential(
                nn.Conv1d(input_size, output_size, 3, padding=1), nn.GELU(),
                nn.Conv1d(output_size, output_size, 3, stride=2, padding=1),
                nn.GELU())
        elif layer in _CONV2D:
            k2, s2 = _CONV2D[layer]
            mods = [nn.Conv2d(1, output_size, 3, 2), nn.ReLU(),
                    nn.Conv2d(output_size, output_size, k2, s2), nn.ReLU()]
            f = ((input_size - 1) // 2 - k2) // s2 + 1
            if layer == "conv2d8":
                mods += [nn.Conv2d(output_size, output_size, 3, 2), nn.ReLU()]
                f = (f - 3) // 2 + 1
            if f <= 0:
                raise ValueError(f"input_size={input_size} is too small for "
                                 f"{layer!r}: the VALID conv stack consumes "
                                 "the whole feature axis")
            self.conv = nn.Sequential(*mods)
            lin = nn.Linear(output_size * f, output_size)
            if layer in ("conv2d", "conv2d4"):
                self.out = nn.Sequential(lin)
            else:
                self.linear = lin
        else:
            raise ValueError(f"unknown input_layer {layer!r}")

    def forward(self, x):
        if self.layer in ("linear", "linear_legacy"):
            x = self.out(x)
            return F.relu(x) if self.layer == "linear_legacy" else x
        if self.layer == "conv1d2":
            return self.conv(x.transpose(1, 2)).transpose(1, 2)
        x = self.conv(x[:, None])                          # [B, C, T', F']
        b, c, t, f = x.shape
        x = x.transpose(1, 2).reshape(b, t, c * f)         # c-major flatten
        return (self.out(x) if self.layer in ("conv2d", "conv2d4")
                else self.linear(x))


class ConformerEncoder(nn.Module):
    """Input layer -> x*sqrt(d), then the rel-pos encoder layers and a final
    LayerNorm."""

    def __init__(self, config: EncoderStackConfig, max_len: int = 4096):
        super().__init__()
        cfg = self.config = config
        self.max_len = max_len
        self.embed = _Embed(cfg.input_layer, cfg.input_size, cfg.output_size)
        conformer_names = cfg.input_layer != "linear_legacy"
        act = cfg.activation_type if conformer_names else "relu"
        self.encoders = nn.ModuleList(
            EncoderLayer(cfg.output_size, cfg.attention_heads, cfg.linear_units,
                         act, conformer_names, cfg.quantized_serving,
                         cfg.fused_qkv_serving, cfg.fused_mlp_serving,
                         cfg.macaron_style, cfg.use_cnn_module,
                         cfg.cnn_module_kernel, cfg.cnn_module_norm,
                         cfg.cnn_causal)
            for _ in range(cfg.num_blocks))
        self.after_norm = nn.LayerNorm(cfg.output_size, eps=1e-5)
        self.register_buffer("pe_table", torch.from_numpy(
            espnet_rel_pos_table(cfg.output_size, max_len)), persistent=False)

    @property
    def dtype(self) -> torch.dtype:
        return self.after_norm.weight.dtype

    def _embed(self, x):
        x = self.embed(x.to(self.dtype))
        return x * torch.tensor(math.sqrt(self.config.output_size),
                                dtype=x.dtype, device=x.device)

    def subsampled_length(self, t_in: int) -> int:
        """Output frame count of the input layer for a t_in-frame input."""
        il = self.config.input_layer
        if il in ("linear", "linear_legacy"):
            return t_in
        if il == "conv1d2":
            return (t_in + 1) // 2
        t = (t_in - 1) // 2
        if il in ("conv2d", "conv2d4"):
            return (t - 1) // 2
        if il == "conv2d6":
            return (t - 4) // 3
        return ((t - 1) // 2 - 1) // 2

    def subsample_lengths(self, lengths: torch.Tensor, t_in: int,
                          t_out: int) -> torch.Tensor:
        """Valid-length mapping of the stems, as the reference slices its
        mask: ceil((len - p0) / step) clipped to [0, t_out]."""
        il = self.config.input_layer
        if il in ("linear", "linear_legacy"):
            return lengths
        p0, step = {"conv1d2": ((t_in + 1) % 2, 2), "conv2d": (6, 4),
                    "conv2d4": (6, 4), "conv2d6": (10, 6),
                    "conv2d8": (14, 8)}[il]
        return torch.clamp(
            torch.div(lengths - p0 + step - 1, step, rounding_mode="floor"),
            0, t_out)

    def forward(self, x, lengths=None, causal: Optional[bool] = None,
                train: bool = False):
        """Full-sequence forward: x [B, T, input_size] -> [B, T', output_size]
        (T' = subsampled_length(T)); `train` moves the conv module's
        BatchNorm statistics."""
        cfg = self.config
        t_in = x.shape[1]
        x = self._embed(x)
        t = x.shape[1]
        pe = self.pe_table[self.max_len - t: self.max_len + t - 1]
        if causal is None:
            causal = cfg.static_chunk_size > 0
        mask = chunk_causal_mask(t, cfg.static_chunk_size if causal else 0,
                                 x.device)[None, None]
        sc = bool(causal) and cfg.static_chunk_size == 1
        pad_mask = None
        if lengths is not None:
            valid = length_mask(self.subsample_lengths(lengths, t_in, t), t)
            mask = mask & valid[:, None, None, :]
            pad_mask = valid if cfg.use_cnn_module else None
        for layer in self.encoders:
            x, _ = call_layer(layer, cfg.remat, x, pe, mask, causal_scores=sc,
                              pad_mask=pad_mask, train=train)
        return self.after_norm(x)

    def init_cache(self, batch: int, max_len: int) -> List[Dict[str, torch.Tensor]]:
        cfg = self.config
        h, dk = cfg.attention_heads, cfg.output_size // cfg.attention_heads
        w = self.after_norm.weight
        return [{"k": w.new_zeros((batch, max_len, h, dk)),
                 "v": w.new_zeros((batch, max_len, h, dk))}
                for _ in range(cfg.num_blocks)]

    def precompute_pos_projs(self, total: int) -> List[torch.Tensor]:
        """Each layer's linear_pos over the rel-pos window of a decode
        session with cache length `total`, computed once per session."""
        pe = self.pe_table[self.max_len - total: self.max_len + total - 1]
        return [layer.self_attn.linear_pos(pe) for layer in self.encoders]

    def decode_step(self, x, caches, index: int, key_valid=None,
                    pos_projs=None):
        """One-token (or prefill-chunk) step: x [B, S, input_size], `index`
        the absolute position of x[:, 0].  Attends to cache positions <= its
        own; `key_valid` [B, 1, 1, Tk] also masks invalid cache slots.
        The stack takes neither the conv module nor a subsampling stem."""
        if self.config.use_cnn_module or self.config.input_layer not in (
                "linear", "linear_legacy"):
            raise ValueError("decode_step needs a linear input layer and no "
                             "conv module (as JAX's)")
        b, s, _ = x.shape
        x = self._embed(x)
        tk = caches[0]["k"].shape[1]
        start = self.max_len - 1 - index - (s - 1)
        pe = self.pe_table[start: start + tk + s - 1]
        dev = x.device
        q_pos = index + torch.arange(s, device=dev)[None, None, :, None]
        mask = torch.arange(tk, device=dev)[None, None, None, :] <= q_pos
        if key_valid is not None:
            mask = mask & key_valid
        for li, (layer, cache) in enumerate(zip(self.encoders, caches)):
            pp = None
            if pos_projs is not None:
                off = tk - 1 - index - (s - 1)
                pp = pos_projs[li][off: off + tk + s - 1]
            x, _ = layer(x, pe, mask=mask, cache=cache, cache_index=index,
                         pos_proj=pp)
        return self.after_norm(x), caches
