# Frozen copy of taste_spokenlm_tpu_torch/models/audio_tower.py at commit 1a9abc6: the plain path
# that the benchmark holds the port against.  Kernel, remat and
# data-parallel routes resolve to portbench/reference/stubs.py.
"""TASTE audio tower: the text-aligned speech tokenizer (counterpart of the
JAX models/audio_tower.py joint encoder-segmenter path).

mel -> whisper encoder (final hidden + a middle layer's hidden) -> whisper
decoder over [prompt | asr tokens | eos] with split K/V cross-attention ->
drop prompt and eos -> word-level mean pooling -> residual VQ.  The
forward trains (`train`: the RVQ's quantize dropout, EMA update and
dead-code expiry, and the batch-level audio dropout); an encoder whose
parameters are all frozen runs under no_grad, as JAX's stop_gradient and
dead-code elimination leave it.

`fuse_forward_type="add_and_norm"` feeds the decoder's cross-attention
one source, LayerNorm(final hidden + middle hidden) (`early_exit_layer_norm`),
for its keys and its values.  The legacy segmenter
(`is_joint_encoder_segmenter=False`) has no decoder: the middle layer's
hidden is mean-pooled over each token's alignment interval
(`asr_token_alignments` [B, T, 2], (start, end) in [0, 1] of the frames)
and mapped to `encoder_input_size` by `audio_affine_layer`.

Module names follow the reference TasteAudioTower
(audio_joint_encoder_segmenter.audio_encoder.encoder.*,
audio_joint_encoder_segmenter.audio_segmenter.decoder.*, vq.rvq.*).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from portbench.reference.config import AudioTowerConfig
from portbench.reference.quantizer import ResidualVQ
from portbench.reference.whisper import WhisperDecoder, WhisperEncoder
from portbench.reference.masking import length_mask
from portbench.reference.segment import (alignment_mean_pool,
                                                 segment_mean_pool)
from portbench.reference import stubs as mesh


class _Holder(nn.Module):
    def __init__(self, **children):
        super().__init__()
        for name, mod in children.items():
            setattr(self, name, mod)


class TasteAudioTower(nn.Module):
    """`dtype` is the encoder's compute dtype; with `segmenter_f32` the
    decoder, pooling and RVQ run in float32 (the RVQ always does)."""

    def __init__(self, config: AudioTowerConfig,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = self.config = config
        if cfg.fuse_forward_type not in ("asr_attn_pooling", "add_and_norm"):
            raise ValueError(f"fuse_forward_type {cfg.fuse_forward_type!r}")
        seg_dtype = torch.float32 if cfg.segmenter_f32 else dtype
        parts = {"audio_encoder": _Holder(
            encoder=WhisperEncoder(cfg.whisper).to(dtype))}
        if cfg.is_joint_encoder_segmenter:
            parts["audio_segmenter"] = _Holder(
                decoder=WhisperDecoder(cfg.whisper).to(seg_dtype))
            if cfg.fuse_forward_type == "add_and_norm":
                self.early_exit_layer_norm = nn.LayerNorm(
                    cfg.whisper.d_model, eps=1e-5).to(seg_dtype)
        else:
            self.audio_affine_layer = nn.Linear(
                cfg.whisper.d_model, cfg.encoder_input_size).to(seg_dtype)
        self.audio_joint_encoder_segmenter = _Holder(**parts)
        if cfg.quantization_on:
            self.vq = _Holder(rvq=ResidualVQ(cfg.quantizer))
        self.seg_dtype = seg_dtype

    @property
    def encoder(self) -> WhisperEncoder:
        return self.audio_joint_encoder_segmenter.audio_encoder.encoder

    @property
    def decoder(self) -> WhisperDecoder:
        return self.audio_joint_encoder_segmenter.audio_segmenter.decoder

    def _encode(self, mel):
        """The encoder's final and middle hidden; under no_grad when its
        parameters are all frozen."""
        frozen = not any(p.requires_grad for p in self.encoder.parameters())
        with torch.set_grad_enabled(torch.is_grad_enabled() and not frozen):
            return self.encoder(
                mel, collect_layer=self.config.encoder_target_hidden_layer)

    def _segment(self, mel, asr_token_ids, asr_token_lengths, asr_word_ids):
        cfg = self.config
        b = asr_token_ids.shape[0]
        dev = asr_token_ids.device
        enc = self._encode(mel)
        prompt = torch.tensor(cfg.whisper.decoder_prompt, dtype=torch.long,
                              device=dev)[None].expand(b, -1)
        eos = torch.full((b, 1), cfg.whisper.eos_token_id, dtype=torch.long,
                         device=dev)
        tokens = torch.cat([prompt, asr_token_ids.long(), eos], dim=1)
        if cfg.fuse_forward_type == "add_and_norm":
            fused = enc["last_hidden"] + enc["target_hidden"]
            key_src = val_src = self.early_exit_layer_norm(
                fused.to(self.seg_dtype))
        else:
            key_src = enc["last_hidden"].to(self.seg_dtype)
            val_src = enc["target_hidden"].to(self.seg_dtype)
        n_prompt = len(cfg.whisper.decoder_prompt)
        dec_out, _ = self.decoder(tokens, key_src, val_src,
                                  input_lengths=asr_token_lengths + n_prompt + 1)
        feats = dec_out[:, n_prompt:-1]
        if cfg.is_word_level and asr_word_ids is not None:
            feats = segment_mean_pool(feats, asr_word_ids, asr_token_lengths)
        return feats

    def _legacy_segment(self, mel, asr_token_lengths, alignments,
                        mel_lengths):
        enc = self._encode(mel)
        if mel_lengths is None:
            mel_lengths = torch.full((mel.shape[0],), mel.shape[-1],
                                     dtype=torch.long, device=mel.device)
        feats = alignment_mean_pool(
            enc["target_hidden"].to(self.seg_dtype),
            torch.div(mel_lengths, 2, rounding_mode="floor"),
            alignments.to(mel.device), asr_token_lengths)
        return self.audio_affine_layer(feats)

    def forward(self, mel, asr_token_ids, asr_token_lengths,
                asr_word_ids=None, train: bool = False,
                generator: Optional[torch.Generator] = None,
                skip_vq: bool = False, draws: Optional[Dict] = None,
                asr_token_alignments: Optional[torch.Tensor] = None,
                mel_lengths: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        """mel [B, n_mels, 3000]; asr ids/word ids [B, T]; lengths [B].
        `draws` may hold the train forward's random draws (the RVQ's
        "drop_after", "gumbel" and "dead_picks"; the audio dropout's
        "audio_keep" [B] bool and "audio_noise" [B, T, C] standard normal);
        the rest come from `generator`.  The legacy segmenter reads
        `asr_token_alignments` [B, T, 2] and `mel_lengths` [B] (default
        the mel's frame count)."""
        cfg = self.config
        draws = draws or {}
        if cfg.is_joint_encoder_segmenter:
            feats = self._segment(mel, asr_token_ids, asr_token_lengths,
                                  asr_word_ids)
        else:
            feats = self._legacy_segment(mel, asr_token_lengths,
                                         asr_token_alignments, mel_lengths)
        result = {"audio_unit_lengths": asr_token_lengths}
        if cfg.quantization_on and not skip_vq:
            vq_out = self.vq.rvq(
                feats, mask=length_mask(asr_token_lengths, feats.shape[1]),
                train=train, generator=generator,
                drop_after=draws.get("drop_after"), gumbel=draws.get("gumbel"),
                dead_picks=draws.get("dead_picks"))
            embeds = vq_out["quantized_feats"]
            result["quantized_indices"] = vq_out["quantized_indices"]
            result["commit_loss"] = vq_out["commit_loss"]
        else:
            embeds = feats
        if train and cfg.audio_dropout_ratio > 0.0:
            # batch-level audio dropout (modeling_taste.py:188-199): a row
            # dropped with probability p becomes noise at the batch std
            b = embeds.shape[0]
            keep = draws.get("audio_keep")
            if keep is None:
                keep = mesh.draw_rows(lambda s: torch.rand(
                    s, device=embeds.device, generator=generator), (b,)
                ) >= cfg.audio_dropout_ratio
            noise = draws.get("audio_noise")
            if noise is None:
                noise = mesh.draw_rows(lambda s: torch.randn(
                    s, device=embeds.device, generator=generator),
                    embeds.shape)
            std = mesh.global_std(embeds.float())
            embeds = torch.where(keep.to(embeds.device)[:, None, None], embeds,
                                 (noise.to(embeds.device) * std).to(embeds.dtype))
        result["audio_unit_embeds"] = embeds
        return result
