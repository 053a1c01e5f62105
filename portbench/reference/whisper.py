# Frozen copy of taste_spokenlm_tpu_torch/models/whisper.py at commit 1a9abc6: the plain path
# that the benchmark holds the port against.  Kernel, remat and
# data-parallel routes resolve to portbench/reference/stubs.py.
"""Whisper encoder, split-K/V decoder and ASR decode (counterpart of the
JAX models/whisper.py `WhisperAttention`, `WhisperEncoder`,
`WhisperDecoder` and `WhisperForASR`).

Module names follow HF whisper (q_proj/k_proj/v_proj/out_proj, fc1/fc2,
*_layer_norm, embed_positions), so an HF or TASTE state dict loads with
strict=True.  Activations are [B, T, C].  With `remat` set in the config,
every encoder and decoder layer is checkpointed when autograd records
(ops/remat.py).  The flash-attention kernel has no backward (nor has the
Pallas kernel it replaces): a trainable encoder must not reach it.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from portbench.reference.config import WhisperConfig
from portbench.reference.stubs import resolve_device
from portbench.reference.stubs import (
    can_use_flash, flash_attention, flash_attention_plain)
from portbench.reference.attention import multi_head_attention
from portbench.reference.masking import causal_mask, combine_masks, length_mask
from portbench.reference.stubs import call_layer
from portbench.reference.sampling import gumbel_noise


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


class WhisperForASR(nn.Module):
    """Whisper transcription with the HF pipeline's decode semantics: mel ->
    encoder -> KV-cached decode from the task prompt until EOS, with
    `suppress_ids` / `begin_suppress_ids` masking, timestamp suppression
    and optional temperature sampling (the building block of
    frontend.processor.transcribe_with_fallback).

    `encoder` / `decoder` may be given to share another model's modules,
    as the TASTE audio tower's (`from_tower`), and stay where they are;
    else new ones are built on `device` (None: CUDA, which must be
    present)."""

    def __init__(self, config: WhisperConfig,
                 encoder: Optional[WhisperEncoder] = None,
                 decoder: Optional[WhisperDecoder] = None,
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__()
        cfg = self.config = config
        if encoder is None or decoder is None:
            with torch.device(resolve_device(device)):
                encoder = encoder if encoder is not None else \
                    WhisperEncoder(cfg)
                decoder = decoder if decoder is not None else \
                    WhisperDecoder(cfg)
        self.encoder, self.decoder = encoder, decoder
        sup = np.zeros((cfg.vocab_size,), np.float32)
        sup[list(cfg.suppress_ids)] = -np.inf
        if cfg.timestamp_begin_id >= 0:
            sup[cfg.timestamp_begin_id:] = -np.inf
        begin = np.zeros((cfg.vocab_size,), np.float32)
        begin[list(cfg.begin_suppress_ids)] = -np.inf
        dev = self.decoder.embed_tokens.weight.device
        self.register_buffer("suppress_mask", torch.from_numpy(sup).to(dev),
                             persistent=False)
        self.register_buffer("begin_mask", torch.from_numpy(begin).to(dev),
                             persistent=False)

    @classmethod
    def from_tower(cls, audio_tower) -> "WhisperForASR":
        """The ASR over a TasteAudioTower's own encoder and decoder."""
        return cls(audio_tower.config.whisper, audio_tower.encoder,
                   audio_tower.decoder)

    @torch.no_grad()
    def forward(self, mel: torch.Tensor, max_tokens: int = 224,
                temperature: float = 0.0,
                generator: Optional[torch.Generator] = None,
                gumbel: Optional[torch.Tensor] = None):
        """mel [B, n_mels, frames] -> (token ids [B, max_tokens] EOS-padded,
        average logprob [B] of the emitted tokens, EOS included).

        At temperature > 0 each step draws a categorical as argmax(logits /
        temperature + gumbel): the noise is `gumbel[step]` ([max_tokens, B,
        V]) or drawn from `generator` on the generator's own device.  The
        decode stops once every row has emitted EOS, or at max_tokens."""
        cfg = self.config
        b, dev = mel.shape[0], mel.device
        enc = self.encoder(mel)["last_hidden"]
        prompt = torch.tensor(cfg.decoder_prompt, dtype=torch.long,
                              device=dev)[None].expand(b, -1)
        p = prompt.shape[1]
        if p + max_tokens > cfg.max_target_positions:
            raise ValueError(
                f"max_tokens {max_tokens} past the decoder's "
                f"{cfg.max_target_positions} positions less the "
                f"{p}-token prompt")
        caches = self.decoder.init_cache(b, p + max_tokens)
        hidden, caches = self.decoder(prompt, enc, caches=caches,
                                      cache_index=0)
        last = hidden[:, -1]
        table = self.decoder.embed_tokens.weight.float()
        tokens = torch.full((b, max_tokens), cfg.eos_token_id,
                            dtype=torch.long, device=dev)
        sum_lp = torch.zeros((b,), device=dev)
        n_emitted = torch.zeros((b,), dtype=torch.long, device=dev)
        done = torch.zeros((b,), dtype=torch.bool, device=dev)
        for step in range(max_tokens):
            if bool(done.all()):
                break
            # the tied embedding is the head
            logits = last.float() @ table.T + self.suppress_mask[None]
            if step == 0:
                logits = logits + self.begin_mask[None]
            if temperature > 0.0:
                if gumbel is not None:
                    noise = gumbel[step].to(dev)
                else:
                    noise = gumbel_noise(
                        logits.shape, generator,
                        generator.device if generator is not None else dev
                    ).to(dev)
                ids = torch.argmax(logits / max(temperature, 1e-6) + noise,
                                   dim=-1)
            else:
                ids = torch.argmax(logits, dim=-1)
            lp = torch.log_softmax(logits, dim=-1).gather(1, ids[:, None])[:, 0]
            emit = torch.where(done, torch.full_like(ids, cfg.eos_token_id),
                               ids)
            tokens[:, step] = emit
            sum_lp = sum_lp + torch.where(done, torch.zeros_like(lp), lp)
            n_emitted = n_emitted + (~done).long()
            done = done | (ids == cfg.eos_token_id)
            hidden, caches = self.decoder(emit[:, None], enc,
                                          position_offset=p + step,
                                          caches=caches, cache_index=p + step)
            last = hidden[:, 0]
        return tokens, sum_lp / torch.clamp(n_emitted, min=1)
