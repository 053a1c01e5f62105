"""TasteForCausalLM (counterpart of the JAX models/taste.py `extract_vq`,
`inference_reconstruction`, `vocode`, `generate_completion`,
`synthesize_from_taste` and the stage-1 `forward_speech_autoencoder`).

Holds the audio tower, the speech decoder, the spoken LM and the voice
generator.  Reconstruction: wav -> taste -> S3 -> mel -> wav.  Completion:
`generate_completion` (the joint text + taste decode) and then, after the
host's tokenizer round trip, `synthesize_from_taste`.  Training: the
stage-1 teacher-forced forward (tokenizer + S3 decoder, train/train_step.py)
is ported; the stage-2 teacher-forced spoken-LM forward, and with it
reconstruction in mode "SpokenLLM", is not (ROADMAP.md queue A item 11).

Entry points run on the CUDA device unless the constructor is given
``device="cpu"``; without CUDA they raise.  Random draws come from a
`torch.Generator` or are passed in as tensors.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn as nn

from taste_spokenlm_tpu_torch.config import TasteConfig
from taste_spokenlm_tpu_torch.device import resolve_device
from taste_spokenlm_tpu_torch.models.audio_tower import TasteAudioTower
from taste_spokenlm_tpu_torch.models.generator import VoiceGenerator
from taste_spokenlm_tpu_torch.models.quantizer import Codebook
from taste_spokenlm_tpu_torch.models.sampler import SamplerConfig
from taste_spokenlm_tpu_torch.models.speech_decoder import TasteSpeechDecoder
from taste_spokenlm_tpu_torch.models.spoken_lm import TasteSpokenLM
from taste_spokenlm_tpu_torch.ops.segment import remap_gather, word_start_remap


class TasteForCausalLM(nn.Module):
    """`dtype` is the compute dtype of the speech decoder, the spoken LM and
    the voice generator; `tower_dtype` (default `dtype`) that of the audio
    tower's encoder (its segmenter and RVQ run float32 under
    `segmenter_f32`)."""

    def __init__(self, config: TasteConfig, dtype: torch.dtype = torch.float32,
                 tower_dtype: Optional[torch.dtype] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 weight_commit_loss: float = 1.0):
        super().__init__()
        self.config = config
        self.weight_commit_loss = weight_commit_loss
        self.device = resolve_device(device)
        self.audio_tower = TasteAudioTower(
            config.audio_tower, dtype=tower_dtype or dtype)
        self.speech_decoder = TasteSpeechDecoder(config.speech_decoder,
                                                 dtype=dtype)
        q = config.audio_tower.quantizer
        self.spoken_lm = TasteSpokenLM(
            config.spoken_lm, audio_dim=config.audio_tower.audio_embed_dim,
            taste_k=q.codebook_size, taste_d=q.codebook_dim,
            taste_l=q.num_quantizers, dtype=dtype)
        self.voice_generator = VoiceGenerator(config.flow, config.hift,
                                              dtype=dtype)
        self.to(self.device)

    def set_use_kernels(self, flag: bool) -> None:
        """Route every kernel call site to its kernel (True) or to the
        kernel's plain PyTorch version (False), to hold one against the
        other on the card."""
        for m in self.modules():
            if hasattr(m, "use_kernels"):
                m.use_kernels = flag

    def _cb(self) -> Codebook:
        return self.audio_tower.vq.rvq.codebook()

    def forward_speech_autoencoder(
        self, speaker_embeds, asr_token_ids, asr_token_lengths, asr_word_ids,
        audio_features, speech_token_ids, speech_token_lengths,
        train: bool = False, generator: Optional[torch.Generator] = None,
        skip_vq: bool = False, skip_audio_in_decoder: bool = False,
        draws: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
        """Stage 1: tokenize the audio and reconstruct its S3 tokens ->
        loss (decoder CE + weight_commit_loss x commit), speech logits,
        labels, speech_token_accuracy and, unless `skip_vq`, commit_loss and
        quantized_indices.  `train` runs the RVQ's train forward (its draws
        from `draws` or `generator`, as TasteAudioTower.forward says)."""
        encoded = self.audio_tower(
            audio_features, asr_token_ids, asr_token_lengths, asr_word_ids,
            train=train, generator=generator, skip_vq=skip_vq, draws=draws)
        decoded = self.speech_decoder(
            speaker_embeds, encoded["audio_unit_embeds"],
            encoded["audio_unit_lengths"], asr_token_ids, asr_token_lengths,
            speech_token_ids, speech_token_lengths,
            skip_audio=skip_audio_in_decoder)
        loss = decoded["loss"]
        out = {"speech_logits": decoded["logits"],
               "speech_labels": decoded["labels"],
               "speech_token_accuracy": decoded["speech_token_accuracy"]}
        if "commit_loss" in encoded:
            loss = loss + self.weight_commit_loss * encoded["commit_loss"]
            out["commit_loss"] = encoded["commit_loss"]
            out["quantized_indices"] = encoded["quantized_indices"]
        out["loss"] = loss
        return out

    @torch.no_grad()
    def extract_vq(self, asr_token_ids, asr_token_lengths, asr_word_ids,
                   llm_token_ids, llm_token_lengths, llm_word_ids,
                   audio_features) -> Tuple[torch.Tensor, torch.Tensor]:
        """audio -> (asr_indices [B, Ta, L], llm_indices [B, Tl, L]); llm
        positions that are not word starts hold -1."""
        encoded = self.audio_tower(audio_features, asr_token_ids,
                                   asr_token_lengths, asr_word_ids)
        asr_indices = encoded["quantized_indices"]
        m = word_start_remap(asr_word_ids, asr_token_lengths, llm_word_ids,
                             llm_token_lengths)
        return asr_indices, remap_gather(m, asr_indices, fill=-1)

    @torch.no_grad()
    def inference_reconstruction(
        self, speaker_embeds, asr_token_ids, asr_token_lengths, asr_word_ids,
        audio_features, mode: str = "SpeechAutoEncoder",
        max_speech_steps: int = 512, mel_len_max: int = 1024,
        sampling_k: int = 25, generator: Optional[torch.Generator] = None,
        gumbel: Optional[torch.Tensor] = None,
        z: Optional[torch.Tensor] = None,
        source_phase: Optional[torch.Tensor] = None,
        source_noise: Optional[torch.Tensor] = None,
    ) -> Dict[str, torch.Tensor]:
        """audio -> taste -> S3 tokens -> waveform.

        `gumbel` [max_speech_steps, B, V+1] is the S3 sampling noise; `z`,
        `source_phase` and `source_noise` the voice generator's draws.  Each
        comes from `generator` when not given."""
        if mode == "SpokenLLM":
            raise NotImplementedError(
                "mode 'SpokenLLM' needs the teacher-forced spoken-LM forward: "
                "ROADMAP.md queue A item 11")
        if mode != "SpeechAutoEncoder":
            raise ValueError(mode)
        encoded = self.audio_tower(audio_features, asr_token_ids,
                                   asr_token_lengths, asr_word_ids)
        gen = self.speech_decoder.generate(
            speaker_embeds, encoded["audio_unit_embeds"],
            encoded["audio_unit_lengths"], asr_token_ids, asr_token_lengths,
            max_steps=max_speech_steps, sampling_k=sampling_k,
            generator=generator, gumbel=gumbel)
        tokens = torch.clamp(gen["speech_token_ids"], min=0)
        wav, wav_lengths = self.voice_generator(
            tokens, gen["speech_token_lengths"], speaker_embeds, mel_len_max,
            generator=generator, z=z, source_phase=source_phase,
            source_noise=source_noise)
        return {"quantized_indices": encoded["quantized_indices"],
                "speech_token_ids": gen["speech_token_ids"],
                "speech_token_lengths": gen["speech_token_lengths"],
                "waveform": wav, "waveform_lengths": wav_lengths}

    @torch.no_grad()
    def vocode(self, speech_token_ids, speech_token_lengths, speaker_embeds,
               mel_len_max: int = 1024,
               generator: Optional[torch.Generator] = None,
               z: Optional[torch.Tensor] = None,
               source_phase: Optional[torch.Tensor] = None,
               source_noise: Optional[torch.Tensor] = None
               ) -> Dict[str, torch.Tensor]:
        """S3 tokens -> waveform, bypassing the tower and speech decoder;
        ids outside the speech vocabulary (EOS / pad markers) are clamped."""
        tokens = torch.clamp(speech_token_ids, 0,
                             self.config.speech_decoder.speech_token_size - 1)
        wav, wav_lengths = self.voice_generator(
            tokens, speech_token_lengths, speaker_embeds, mel_len_max,
            generator=generator, z=z, source_phase=source_phase,
            source_noise=source_noise)
        return {"speech_token_ids": speech_token_ids,
                "speech_token_lengths": speech_token_lengths,
                "waveform": wav, "waveform_lengths": wav_lengths}

    @torch.no_grad()
    def generate_completion(self, sampler_cfg: SamplerConfig, tables,
                            llm_indices, llm_token_ids, llm_token_lengths,
                            llm_word_ids, conditional_mode: str = "audio",
                            max_steps: int = 256, instruct_prefix_ids=None,
                            instruct_suffix_ids=None,
                            generator: Optional[torch.Generator] = None,
                            text_gumbel: Optional[torch.Tensor] = None,
                            taste_gumbel: Optional[torch.Tensor] = None
                            ) -> Dict[str, torch.Tensor]:
        """The joint text + taste decode (the device part of the reference's
        inference_completion); `tables` maps word_start / banned /
        sentence_end to bool tensors [V] (models/sampler.py)."""
        return self.spoken_lm.generate(
            self._cb(), sampler_cfg, tables, llm_indices, llm_token_ids,
            llm_token_lengths, llm_word_ids, conditional_mode, max_steps,
            instruct_prefix_ids, instruct_suffix_ids, generator=generator,
            text_gumbel=text_gumbel, taste_gumbel=taste_gumbel)

    @torch.no_grad()
    def synthesize_from_taste(
        self, speaker_embeds, taste_indices_per_word, asr_token_ids,
        asr_token_lengths, asr_word_ids, max_speech_steps: int = 512,
        mel_len_max: int = 1024, sampling_k: int = 25,
        generator: Optional[torch.Generator] = None,
        gumbel: Optional[torch.Tensor] = None,
        z: Optional[torch.Tensor] = None,
        source_phase: Optional[torch.Tensor] = None,
        source_noise: Optional[torch.Tensor] = None,
    ) -> Dict[str, torch.Tensor]:
        """Per-word taste indices [B, Tw, L] + asr tokens -> waveform (the
        tail of inference_completion); noise arguments as in
        inference_reconstruction."""
        audio_unit_embeds = self.spoken_lm.get_audio_embeds_from_taste(
            self._cb(), asr_token_lengths, asr_word_ids, taste_indices_per_word)
        gen = self.speech_decoder.generate(
            speaker_embeds, audio_unit_embeds, asr_token_lengths, asr_token_ids,
            asr_token_lengths, max_steps=max_speech_steps,
            sampling_k=sampling_k, generator=generator, gumbel=gumbel)
        tokens = torch.clamp(gen["speech_token_ids"], min=0)
        wav, wav_lengths = self.voice_generator(
            tokens, gen["speech_token_lengths"], speaker_embeds, mel_len_max,
            generator=generator, z=z, source_phase=source_phase,
            source_noise=source_noise)
        return {"speech_token_ids": gen["speech_token_ids"],
                "speech_token_lengths": gen["speech_token_lengths"],
                "waveform": wav, "waveform_lengths": wav_lengths}
