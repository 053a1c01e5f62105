"""TASTE speech decoder: (taste units + text) -> S3 speech tokens
(counterpart of the JAX models/speech_decoder.py inference path).

  text ids  -> embed -> causal conformer -> affine
  taste emb -> affine -> causal conformer -> affine
  fuse (softmax-weighted sum)
  prefix = [sos | spk | fused | task], packed left-padded
  KV-cached AR decode of the llm conformer -> head (V+1, last = EOS)

Module names follow the reference TasteSpeechDecoder state dict.  The
training forward (loss), `generate_stream_resume` and the concat fusions
are not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from taste_spokenlm_tpu_torch.config import SpeechDecoderConfig
from taste_spokenlm_tpu_torch.models.conformer import ConformerEncoder
from taste_spokenlm_tpu_torch.ops.quantized import dense
from taste_spokenlm_tpu_torch.ops.sampling import sample
from taste_spokenlm_tpu_torch.ops.segment import ragged_concat


class _Fuse(nn.Module):
    def __init__(self, init_type: str):
        super().__init__()
        init = {"balance": [1.0, 1.0], "zero_audio": [-2.0, 2.0]}[init_type]
        self.weights = nn.Parameter(torch.tensor(init))


class TasteSpeechDecoder(nn.Module):
    def __init__(self, config: SpeechDecoderConfig,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = self.config = config
        if cfg.fuse_type != "weighted_sum" or cfg.fuse_normalize:
            raise NotImplementedError(
                f"fuse_type {cfg.fuse_type!r}, fuse_normalize "
                f"{cfg.fuse_normalize}")
        self.text_embedding = nn.Embedding(cfg.text_token_size,
                                           cfg.text_encoder_input_size)
        self.text_encoder = ConformerEncoder(cfg.text_encoder)
        self.text_encoder_affine_layer = nn.Linear(cfg.text_encoder.output_size,
                                                   cfg.llm_input_size)
        self.audio_embed_affine_layer = nn.Linear(cfg.audio_encoder_input_size,
                                                  cfg.text_encoder_input_size)
        self.audio_token_encoder = ConformerEncoder(cfg.audio_encoder)
        self.audio_token_encoder_affine_layer = nn.Linear(
            cfg.audio_encoder.output_size, cfg.llm_input_size)
        self.fuse_encoded_audio_text_module = _Fuse(cfg.fuse_weight_init_type)
        self.llm_embedding = nn.Embedding(2, cfg.llm_input_size)
        self.llm = ConformerEncoder(cfg.llm)
        # the logits head rides the llm stack's serving quantization
        self.llm_decoder = dense(cfg.llm_output_size, cfg.speech_token_size + 1,
                                 cfg.llm.quantized_serving)
        self.speech_embedding = nn.Embedding(cfg.speech_token_size,
                                             cfg.llm_input_size)
        self.spk_embed_affine_layer = nn.Linear(cfg.spk_embed_dim,
                                                cfg.llm_input_size)
        self.to(dtype)

    @property
    def dtype(self) -> torch.dtype:
        return self.spk_embed_affine_layer.weight.dtype

    def encode_text(self, asr_token_ids, asr_token_lengths):
        emb = self.text_embedding(asr_token_ids)
        enc = self.text_encoder(emb, asr_token_lengths)
        return self.text_encoder_affine_layer(enc)

    def encode_audio(self, audio_unit_embeds, audio_unit_lengths):
        x = self.audio_embed_affine_layer(audio_unit_embeds.to(self.dtype))
        enc = self.audio_token_encoder(x, audio_unit_lengths)
        return self.audio_token_encoder_affine_layer(enc)

    def fuse(self, audio_encoded, text_encoded, lengths=None):
        """Softmax-weighted sum of the two streams; keeps the aligned
        length."""
        w = torch.softmax(self.fuse_encoded_audio_text_module.weights.float(),
                          dim=0)
        fused = w[0] * audio_encoded.float() + w[1] * text_encoded.float()
        return fused.to(self.dtype), lengths

    def prepare_conditional_embeds(self, speaker_embeds, audio_unit_embeds,
                                   audio_unit_lengths, asr_token_ids,
                                   asr_token_lengths, skip_audio: bool = False):
        """(sos [B,1,C], spk [B,1,C], fused [B,Tf,C], task [B,1,C],
        fused_lengths [B])."""
        b = asr_token_ids.shape[0]
        dev = asr_token_ids.device
        spk = speaker_embeds.float()
        spk = spk / torch.clamp(torch.linalg.norm(spk, dim=-1, keepdim=True),
                                min=1e-8)
        spk = self.spk_embed_affine_layer(spk.to(self.dtype))[:, None, :]
        text_enc = self.encode_text(asr_token_ids, asr_token_lengths)
        fused_lengths = asr_token_lengths
        if skip_audio:
            fused = text_enc
        else:
            audio_enc = self.encode_audio(audio_unit_embeds, audio_unit_lengths)
            fused, fused_lengths = self.fuse(audio_enc, text_enc,
                                             asr_token_lengths)
        rows = self.llm_embedding(torch.tensor([0, 1], device=dev))
        sos = rows[0][None, None].expand(b, 1, -1)
        task = rows[1][None, None].expand(b, 1, -1)
        return sos, spk, fused, task, fused_lengths

    # ------------------------------------------------------------------
    # autoregressive generation (KV-cached)
    # ------------------------------------------------------------------

    @torch.no_grad()
    def generate_stream_init(self, speaker_embeds, audio_unit_embeds,
                             audio_unit_lengths, asr_token_ids,
                             asr_token_lengths, max_steps: int = 512,
                             min_token_text_ratio: float = 2.0,
                             max_token_text_ratio: float = 20.0,
                             skip_audio: bool = False,
                             generator: Optional[torch.Generator] = None
                             ) -> Dict[str, Any]:
        """Pack + prefill; returns the stream state for
        `generate_stream_chunk`."""
        b = asr_token_ids.shape[0]
        dev = asr_token_ids.device
        sos, spk, fused, task, fused_lengths = self.prepare_conditional_embeds(
            speaker_embeds, audio_unit_embeds, audio_unit_lengths,
            asr_token_ids, asr_token_lengths, skip_audio)
        prefix_max = 3 + fused.shape[1]
        packed, prefix_len = ragged_concat(
            [(sos, None), (spk, None), (fused, fused_lengths), (task, None)],
            prefix_max)
        # right-aligned (left-padded) packing: every row shares positions
        shift = prefix_max - prefix_len
        pos = torch.arange(prefix_max, device=dev)[None, :]
        src = torch.clamp(pos - shift[:, None], 0, prefix_max - 1)
        prefix = torch.gather(packed, 1,
                              src[:, :, None].expand(-1, -1, packed.shape[-1]))
        prefix_valid = pos >= shift[:, None]
        prefix = torch.where(prefix_valid[:, :, None], prefix,
                             torch.zeros_like(prefix))
        total = prefix_max + max_steps
        caches = self.llm.init_cache(b, total)
        key_valid = torch.cat(
            [prefix_valid, torch.ones((b, max_steps), dtype=torch.bool,
                                      device=dev)], dim=1)
        pos_projs = self.llm.precompute_pos_projs(total)
        lm_out, caches = self.llm.decode_step(
            prefix, caches, 0, key_valid=key_valid[:, None, None, :],
            pos_projs=pos_projs)
        plen = prefix_len.float()
        min_len = (plen * min_token_text_ratio).to(torch.int32)
        max_len = torch.clamp((plen * max_token_text_ratio).to(torch.int32),
                              max=max_steps)
        return {"step": 0, "generator": generator, "caches": caches,
                "hidden": lm_out[:, -1], "done": torch.zeros(
                    (b,), dtype=torch.bool, device=dev),
                "key_valid": key_valid, "min_len": min_len, "max_len": max_len,
                "prefix_max": prefix_max, "pos_projs": pos_projs}

    @torch.no_grad()
    def generate_stream_chunk(self, state: Dict[str, Any], chunk_steps: int,
                              sampling_k: int = 25,
                              gumbel: Optional[torch.Tensor] = None):
        """Decode up to `chunk_steps` tokens; returns (tokens [B, chunk_steps]
        with -1 after EOS, new state).  Stops early once every row is done.
        `gumbel` [chunk_steps, B, V+1] overrides the sampling noise."""
        cfg = self.config
        b = state["hidden"].shape[0]
        dev = state["hidden"].device
        eos = cfg.speech_token_size
        tokens = torch.full((b, chunk_steps), -1, dtype=torch.long, device=dev)
        step, hidden, done = state["step"], state["hidden"], state["done"]
        kv = state["key_valid"][:, None, None, :]
        for i in range(chunk_steps):
            if bool(done.all()):
                break
            logits = self.llm_decoder(hidden).float()
            forbid = step < state["min_len"]
            ids = sample(logits, top_k=sampling_k, forbid_eos=forbid,
                         eos_id=eos, generator=state["generator"],
                         gumbel=None if gumbel is None else gumbel[i])
            is_eos = ids == eos
            over = step >= state["max_len"]
            stop = done | is_eos | over
            tokens[:, i] = torch.where(stop, torch.full_like(ids, -1), ids)
            done = stop
            emb = self.speech_embedding(torch.clamp(ids, min=0) % eos)[:, None]
            lm_out, _ = self.llm.decode_step(
                emb, state["caches"], state["prefix_max"] + step,
                key_valid=kv, pos_projs=state["pos_projs"])
            hidden = lm_out[:, 0]
            step += 1
        return tokens, dict(state, step=step, hidden=hidden, done=done)

    @torch.no_grad()
    def generate(self, speaker_embeds, audio_unit_embeds, audio_unit_lengths,
                 asr_token_ids, asr_token_lengths, max_steps: int = 512,
                 sampling_k: int = 25, min_token_text_ratio: float = 2.0,
                 max_token_text_ratio: float = 20.0, skip_audio: bool = False,
                 generator: Optional[torch.Generator] = None,
                 gumbel: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """Batched AR decode: speech_token_ids [B, max_steps] (EOS and after
        = -1) and speech_token_lengths [B]."""
        state = self.generate_stream_init(
            speaker_embeds, audio_unit_embeds, audio_unit_lengths,
            asr_token_ids, asr_token_lengths, max_steps=max_steps,
            min_token_text_ratio=min_token_text_ratio,
            max_token_text_ratio=max_token_text_ratio, skip_audio=skip_audio,
            generator=generator)
        tokens, _ = self.generate_stream_chunk(state, max_steps,
                                               sampling_k=sampling_k,
                                               gumbel=gumbel)
        return {"speech_token_ids": tokens,
                "speech_token_lengths": (tokens >= 0).sum(dim=1)}
