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
(ops/remat.py).  The convolution module, macaron FFN and conv subsampling
stems are not ported yet.

Names follow the reference state dict: embed.out.{0,1}, encoders.{i}.
self_attn.linear_{q,k,v,out,pos} (or linear_qkv), pos_bias_u/v,
feed_forward.w_1/w_2, norm_mha/norm_ff (or norm1/norm2 for linear_legacy),
after_norm; a QDense holds kernel_q [in, out], scale and bias, a QDense4
kernel_q4 [in/2, out], scale [in/g, out] and bias.  Decode
caches are written in place.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from taste_spokenlm_tpu_torch.config import EncoderStackConfig
from taste_spokenlm_tpu_torch.kernels.relpos_attention import (
    can_use_relpos_flash, relpos_causal_attention)
from taste_spokenlm_tpu_torch.ops.masking import chunk_causal_mask, length_mask
from taste_spokenlm_tpu_torch.ops.quantized import (dense, fused_ffn_apply,
                                                    qmode)
from taste_spokenlm_tpu_torch.ops.remat import call_layer

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


class EncoderLayer(nn.Module):
    """Pre-LN MHA -> FFN layer; `conformer_names` picks norm_mha/norm_ff
    (else norm1/norm2), as the reference state dicts do."""

    def __init__(self, d_model: int, num_heads: int, ffn_dim: int,
                 activation: str, conformer_names: bool = True,
                 quantized=False, fused_qkv: bool = False,
                 fused_mlp: bool = False):
        super().__init__()
        self.self_attn = RelPositionAttention(d_model, num_heads, quantized,
                                              fused_qkv)
        self.feed_forward = PositionwiseFeedForward(d_model, ffn_dim, activation,
                                                    quantized, fused_mlp)
        self.mha_norm_name = "norm_mha" if conformer_names else "norm1"
        self.ff_norm_name = "norm_ff" if conformer_names else "norm2"
        setattr(self, self.mha_norm_name, nn.LayerNorm(d_model, eps=1e-5))
        setattr(self, self.ff_norm_name, nn.LayerNorm(d_model, eps=1e-5))

    def forward(self, x, pos_emb, mask=None, cache=None, cache_index: int = 0,
                pos_proj=None, causal_scores: bool = False):
        h, new_cache = self.self_attn(
            getattr(self, self.mha_norm_name)(x), pos_emb, mask=mask,
            cache=cache, cache_index=cache_index, pos_proj=pos_proj,
            causal_scores=causal_scores)
        x = x + h
        x = x + self.feed_forward(getattr(self, self.ff_norm_name)(x))
        return x, new_cache


class _Embed(nn.Module):
    def __init__(self, input_size: int, output_size: int):
        super().__init__()
        self.out = nn.Sequential(nn.Linear(input_size, output_size),
                                 nn.LayerNorm(output_size, eps=1e-5))


class ConformerEncoder(nn.Module):
    """Linear -> LayerNorm -> (ReLU if linear_legacy) -> x*sqrt(d), then the
    rel-pos encoder layers and a final LayerNorm."""

    def __init__(self, config: EncoderStackConfig, max_len: int = 4096):
        super().__init__()
        cfg = self.config = config
        if cfg.input_layer not in ("linear", "linear_legacy"):
            raise NotImplementedError(f"input_layer {cfg.input_layer!r}")
        if cfg.use_cnn_module or cfg.macaron_style:
            raise NotImplementedError("conformer conv module / macaron FFN")
        self.max_len = max_len
        self.embed = _Embed(cfg.input_size, cfg.output_size)
        conformer_names = cfg.input_layer != "linear_legacy"
        act = cfg.activation_type if conformer_names else "relu"
        self.encoders = nn.ModuleList(
            EncoderLayer(cfg.output_size, cfg.attention_heads, cfg.linear_units,
                         act, conformer_names, cfg.quantized_serving,
                         cfg.fused_qkv_serving, cfg.fused_mlp_serving)
            for _ in range(cfg.num_blocks))
        self.after_norm = nn.LayerNorm(cfg.output_size, eps=1e-5)
        self.register_buffer("pe_table", torch.from_numpy(
            espnet_rel_pos_table(cfg.output_size, max_len)), persistent=False)

    @property
    def dtype(self) -> torch.dtype:
        return self.after_norm.weight.dtype

    def _embed(self, x):
        x = self.embed.out(x.to(self.dtype))
        if self.config.input_layer == "linear_legacy":
            x = F.relu(x)
        return x * torch.tensor(math.sqrt(self.config.output_size),
                                dtype=x.dtype, device=x.device)

    def forward(self, x, lengths=None, causal: Optional[bool] = None):
        """Full-sequence forward: x [B, T, input_size] -> [B, T, output_size]."""
        cfg = self.config
        x = self._embed(x)
        t = x.shape[1]
        pe = self.pe_table[self.max_len - t: self.max_len + t - 1]
        if causal is None:
            causal = cfg.static_chunk_size > 0
        mask = chunk_causal_mask(t, cfg.static_chunk_size if causal else 0,
                                 x.device)[None, None]
        sc = bool(causal) and cfg.static_chunk_size == 1
        if lengths is not None:
            valid = length_mask(lengths, t)
            mask = mask & valid[:, None, None, :]
        for layer in self.encoders:
            x, _ = call_layer(layer, cfg.remat, x, pe, mask, causal_scores=sc)
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
        own; `key_valid` [B, 1, 1, Tk] also masks invalid cache slots."""
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
