"""Whisper encoder and split-K/V decoder (counterpart of the JAX
models/whisper.py `WhisperAttention`, `WhisperEncoder`, `WhisperDecoder`).

Module names follow HF whisper (q_proj/k_proj/v_proj/out_proj, fc1/fc2,
*_layer_norm, embed_positions), so an HF or TASTE state dict loads with
strict=True.  Activations are [B, T, C].  With `remat` set in the config,
every encoder and decoder layer is checkpointed when autograd records
(ops/remat.py).  The flash-attention kernel has no backward (nor has the
Pallas kernel it replaces): a trainable encoder must not reach it.
`WhisperForASR` is not ported yet.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from taste_spokenlm_tpu_torch.config import WhisperConfig
from taste_spokenlm_tpu_torch.kernels.flash_attention import (
    can_use_flash, flash_attention, flash_attention_plain)
from taste_spokenlm_tpu_torch.ops.attention import multi_head_attention
from taste_spokenlm_tpu_torch.ops.masking import causal_mask, combine_masks, length_mask
from taste_spokenlm_tpu_torch.ops.remat import call_layer


class WhisperAttention(nn.Module):
    """MHA with optional split key/value sources (TASTE asr_attn_pooling).

    Long unmasked self-attention (the encoder's 1500 positions) takes the
    flash-attention kernel, under the JAX gate (`mask is None`, no cache,
    `can_use_flash`).  `use_kernels = False` routes it to the kernel's plain
    version instead, to hold the kernel path against the plain one."""

    def __init__(self, d_model: int, num_heads: int):
        super().__init__()
        self.d_model, self.num_heads = d_model, num_heads
        self.q_proj = nn.Linear(d_model, d_model)
        self.k_proj = nn.Linear(d_model, d_model, bias=False)
        self.v_proj = nn.Linear(d_model, d_model)
        self.out_proj = nn.Linear(d_model, d_model)
        self.use_kernels = True

    def forward(self, hidden, key_source=None, value_source=None, mask=None,
                cache: Optional[Dict[str, torch.Tensor]] = None,
                cache_index: int = 0):
        """hidden [B, Tq, C]; mask bool [B, 1, Tq, Tk].  With `cache`, the
        new keys/values are written into it in place at `cache_index`."""
        b, tq, _ = hidden.shape
        h, d = self.num_heads, self.d_model // self.num_heads
        if key_source is None:
            key_source = hidden
        if value_source is None:
            value_source = key_source
        q = self.q_proj(hidden).view(b, tq, h, d)
        k = self.k_proj(key_source).view(b, key_source.shape[1], h, d)
        v = self.v_proj(value_source).view(b, value_source.shape[1], h, d)
        if cache is not None:
            cache["k"][:, cache_index:cache_index + tq] = k
            cache["v"][:, cache_index:cache_index + tq] = v
            k, v = cache["k"], cache["v"]
        if mask is None and cache is None and can_use_flash(tq, k.shape[1]):
            attend = flash_attention if self.use_kernels else flash_attention_plain
            out = attend(q, k.contiguous(), v.contiguous())
        else:
            out = multi_head_attention(q, k, v, mask=mask)
        return self.out_proj(out.reshape(b, tq, self.d_model)), cache


class WhisperEncoderLayer(nn.Module):
    def __init__(self, d_model: int, num_heads: int, ffn_dim: int):
        super().__init__()
        self.self_attn_layer_norm = nn.LayerNorm(d_model, eps=1e-5)
        self.self_attn = WhisperAttention(d_model, num_heads)
        self.final_layer_norm = nn.LayerNorm(d_model, eps=1e-5)
        self.fc1 = nn.Linear(d_model, ffn_dim)
        self.fc2 = nn.Linear(ffn_dim, d_model)

    def forward(self, x, mask=None):
        h, _ = self.self_attn(self.self_attn_layer_norm(x), mask=mask)
        x = x + h
        h = self.fc2(F.gelu(self.fc1(self.final_layer_norm(x))))
        return x + h


def sinusoidal_positions(length: int, channels: int) -> np.ndarray:
    """Whisper sinusoid table (sin | cos halves, log-space frequencies)."""
    log_timescale_increment = np.log(10000) / (channels // 2 - 1)
    inv_timescales = np.exp(-log_timescale_increment * np.arange(channels // 2))
    scaled_time = np.arange(length)[:, None] * inv_timescales[None, :]
    return np.concatenate([np.sin(scaled_time), np.cos(scaled_time)],
                          axis=1).astype(np.float32)


class WhisperEncoder(nn.Module):
    """mel [B, n_mels, 3000] -> {"last_hidden" [B, 1500, d],
    "target_hidden" (the input of layer `collect_layer`)}."""

    def __init__(self, config: WhisperConfig):
        super().__init__()
        cfg = self.config = config
        self.conv1 = nn.Conv1d(cfg.n_mels, cfg.d_model, 3, padding=1)
        self.conv2 = nn.Conv1d(cfg.d_model, cfg.d_model, 3, stride=2, padding=1)
        self.embed_positions = nn.Embedding(cfg.max_source_positions, cfg.d_model)
        with torch.no_grad():
            self.embed_positions.weight.copy_(torch.from_numpy(
                sinusoidal_positions(cfg.max_source_positions, cfg.d_model)))
        self.layers = nn.ModuleList(
            WhisperEncoderLayer(cfg.d_model, cfg.encoder_heads, cfg.ffn_dim)
            for _ in range(cfg.encoder_layers))
        self.layer_norm = nn.LayerNorm(cfg.d_model, eps=1e-5)

    def forward(self, mel: torch.Tensor, collect_layer: Optional[int] = None
                ) -> Dict[str, torch.Tensor]:
        dtype = self.conv1.weight.dtype
        x = F.gelu(self.conv1(mel.to(dtype)))
        x = F.gelu(self.conv2(x)).transpose(1, 2)           # [B, T, d]
        x = x + self.embed_positions.weight[None, : x.shape[1]]
        collected = None
        for i, layer in enumerate(self.layers):
            if collect_layer is not None and i == collect_layer:
                collected = x
            x = call_layer(layer, self.config.remat, x)
        out = {"last_hidden": self.layer_norm(x)}
        if collected is not None:
            out["target_hidden"] = collected
        return out


class WhisperDecoderLayer(nn.Module):
    def __init__(self, d_model: int, num_heads: int, ffn_dim: int):
        super().__init__()
        self.self_attn = WhisperAttention(d_model, num_heads)
        self.self_attn_layer_norm = nn.LayerNorm(d_model, eps=1e-5)
        self.encoder_attn = WhisperAttention(d_model, num_heads)
        self.encoder_attn_layer_norm = nn.LayerNorm(d_model, eps=1e-5)
        self.fc1 = nn.Linear(d_model, ffn_dim)
        self.fc2 = nn.Linear(ffn_dim, d_model)
        self.final_layer_norm = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, x, enc_key, enc_value, self_mask=None, cross_mask=None,
                cache=None, cache_index: int = 0):
        h, new_cache = self.self_attn(self.self_attn_layer_norm(x),
                                      mask=self_mask, cache=cache,
                                      cache_index=cache_index)
        x = x + h
        h, _ = self.encoder_attn(self.encoder_attn_layer_norm(x),
                                 key_source=enc_key, value_source=enc_value,
                                 mask=cross_mask)
        x = x + h
        h = self.fc2(F.gelu(self.fc1(self.final_layer_norm(x))))
        return x + h, new_cache


class WhisperDecoder(nn.Module):
    """Text decoder cross-attending encoder states, with split K/V sources
    (asr_attn_pooling: K = final hidden, V = a middle layer's hidden)."""

    def __init__(self, config: WhisperConfig):
        super().__init__()
        cfg = self.config = config
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.embed_positions = nn.Embedding(cfg.max_target_positions, cfg.d_model)
        self.layers = nn.ModuleList(
            WhisperDecoderLayer(cfg.d_model, cfg.decoder_heads, cfg.ffn_dim)
            for _ in range(cfg.decoder_layers))
        self.layer_norm = nn.LayerNorm(cfg.d_model, eps=1e-5)

    def forward(self, input_ids, enc_key, enc_value=None, input_lengths=None,
                position_offset: int = 0,
                caches: Optional[List[Dict[str, torch.Tensor]]] = None,
                cache_index: int = 0):
        b, t = input_ids.shape
        dev = input_ids.device
        positions = torch.arange(t, device=dev) + position_offset
        x = self.embed_tokens(input_ids) + self.embed_positions(positions)[None]
        if caches is None:
            self_mask = causal_mask(t, dev)[None, None]
            if input_lengths is not None:
                self_mask = combine_masks(
                    self_mask, length_mask(input_lengths, t)[:, None, None, :])
        else:
            tk = caches[0]["k"].shape[1]
            q_pos = cache_index + torch.arange(t, device=dev)[None, None, :, None]
            self_mask = torch.arange(tk, device=dev)[None, None, None, :] <= q_pos
        if enc_value is None:
            enc_value = enc_key
        new_caches = []
        for i, layer in enumerate(self.layers):
            if caches is None:
                x, c = call_layer(layer, self.config.remat, x, enc_key,
                                  enc_value, self_mask)
            else:
                x, c = layer(x, enc_key, enc_value, self_mask=self_mask,
                             cache=caches[i], cache_index=cache_index)
            new_caches.append(c)
        x = self.layer_norm(x)
        return x, (new_caches if caches is not None else None)

    def init_cache(self, batch: int, max_len: int) -> List[Dict[str, torch.Tensor]]:
        cfg = self.config
        h, d = cfg.decoder_heads, cfg.d_model // cfg.decoder_heads
        w = self.embed_tokens.weight
        return [{"k": w.new_zeros((batch, max_len, h, d)),
                 "v": w.new_zeros((batch, max_len, h, d))}
                for _ in range(cfg.decoder_layers)]
