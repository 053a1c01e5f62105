"""TASTE audio tower: the text-aligned speech tokenizer (counterpart of the
JAX models/audio_tower.py joint encoder-segmenter path).

mel -> whisper encoder (final hidden + a middle layer's hidden) -> whisper
decoder over [prompt | asr tokens | eos] with split K/V cross-attention ->
drop prompt and eos -> word-level mean pooling -> residual VQ.  The
forward trains (`train`: the RVQ's quantize dropout, EMA update and
dead-code expiry, and the batch-level audio dropout); an encoder whose
parameters are all frozen runs under no_grad, as JAX's stop_gradient and
dead-code elimination leave it.

Module names follow the reference TasteAudioTower
(audio_joint_encoder_segmenter.audio_encoder.encoder.*,
audio_joint_encoder_segmenter.audio_segmenter.decoder.*, vq.rvq.*).  The
legacy alignment-pooling segmenter and the add_and_norm fusion are not
ported yet.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from taste_spokenlm_tpu_torch.config import AudioTowerConfig
from taste_spokenlm_tpu_torch.models.quantizer import ResidualVQ
from taste_spokenlm_tpu_torch.models.whisper import WhisperDecoder, WhisperEncoder
from taste_spokenlm_tpu_torch.ops.masking import length_mask
from taste_spokenlm_tpu_torch.ops.segment import segment_mean_pool


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
        if not cfg.is_joint_encoder_segmenter:
            raise NotImplementedError("legacy alignment-pooling segmenter")
        if cfg.fuse_forward_type != "asr_attn_pooling":
            raise NotImplementedError(cfg.fuse_forward_type)
        seg_dtype = torch.float32 if cfg.segmenter_f32 else dtype
        self.audio_joint_encoder_segmenter = _Holder(
            audio_encoder=_Holder(encoder=WhisperEncoder(cfg.whisper).to(dtype)),
            audio_segmenter=_Holder(
                decoder=WhisperDecoder(cfg.whisper).to(seg_dtype)))
        if cfg.quantization_on:
            self.vq = _Holder(rvq=ResidualVQ(cfg.quantizer))
        self.seg_dtype = seg_dtype

    @property
    def encoder(self) -> WhisperEncoder:
        return self.audio_joint_encoder_segmenter.audio_encoder.encoder

    @property
    def decoder(self) -> WhisperDecoder:
        return self.audio_joint_encoder_segmenter.audio_segmenter.decoder

    def _segment(self, mel, asr_token_ids, asr_token_lengths, asr_word_ids):
        cfg = self.config
        b = asr_token_ids.shape[0]
        dev = asr_token_ids.device
        frozen = not any(p.requires_grad for p in self.encoder.parameters())
        with torch.set_grad_enabled(torch.is_grad_enabled() and not frozen):
            enc = self.encoder(mel,
                               collect_layer=cfg.encoder_target_hidden_layer)
        prompt = torch.tensor(cfg.whisper.decoder_prompt, dtype=torch.long,
                              device=dev)[None].expand(b, -1)
        eos = torch.full((b, 1), cfg.whisper.eos_token_id, dtype=torch.long,
                         device=dev)
        tokens = torch.cat([prompt, asr_token_ids.long(), eos], dim=1)
        key_src = enc["last_hidden"].to(self.seg_dtype)
        val_src = enc["target_hidden"].to(self.seg_dtype)
        n_prompt = len(cfg.whisper.decoder_prompt)
        dec_out, _ = self.decoder(tokens, key_src, val_src,
                                  input_lengths=asr_token_lengths + n_prompt + 1)
        feats = dec_out[:, n_prompt:-1]
        if cfg.is_word_level and asr_word_ids is not None:
            feats = segment_mean_pool(feats, asr_word_ids, asr_token_lengths)
        return feats

    def forward(self, mel, asr_token_ids, asr_token_lengths,
                asr_word_ids=None, train: bool = False,
                generator: Optional[torch.Generator] = None,
                skip_vq: bool = False, draws: Optional[Dict] = None
                ) -> Dict[str, torch.Tensor]:
        """mel [B, n_mels, 3000]; asr ids/word ids [B, T]; lengths [B].
        `draws` may hold the train forward's random draws (the RVQ's
        "drop_after", "gumbel" and "dead_picks"; the audio dropout's
        "audio_keep" [B] bool and "audio_noise" [B, T, C] standard normal);
        the rest come from `generator`."""
        cfg = self.config
        draws = draws or {}
        feats = self._segment(mel, asr_token_ids, asr_token_lengths,
                              asr_word_ids)
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
                keep = torch.rand((b,), device=embeds.device,
                                  generator=generator) >= cfg.audio_dropout_ratio
            noise = draws.get("audio_noise")
            if noise is None:
                noise = torch.randn(embeds.shape, device=embeds.device,
                                    generator=generator)
            std = embeds.float().std(unbiased=False)
            embeds = torch.where(keep.to(embeds.device)[:, None, None], embeds,
                                 (noise.to(embeds.device) * std).to(embeds.dtype))
        result["audio_unit_embeds"] = embeds
        return result
