"""TasteForCausalLM (counterpart of the JAX models/taste.py `extract_vq`,
`scoring`, `inference_reconstruction`, `vocode`, `generate_completion`,
`synthesize_from_taste`, the streaming methods and the training forwards
`forward_speech_autoencoder` and `forward_spoken_llm`).

Holds the audio tower, the speech decoder, the spoken LM and the voice
generator.  Reconstruction: wav -> taste -> S3 -> mel -> wav, the taste
from the tower ("SpeechAutoEncoder") or from the spoken LM's
teacher-forced forward over the llm tokens ("SpokenLLM").  Completion:
`generate_completion` (the joint text + taste decode) and then, after the
host's tokenizer round trip, `synthesize_from_taste`.  Training
(train/train_step.py): stage 1 (tokenizer + S3 decoder) and stage 2 (the
teacher-forced spoken LM, optionally with the frozen speech decoder run on
its predicted taste as an eval measurement).

Streaming (`stream_*`, `completion_*`): the S3 decode runs in chunks from
a stream state, each chunk's window of tokens (left context + the chunk)
is vocoded on its own, and the joint decode runs in chunks too
(frontend/streaming.py drives them).  The token history lives on the
device ([B, max_steps + max(chunk, hist_pad)], zero-padded) with its
length `hist_len` (an int or a 0-d tensor).

Entry points run on the CUDA device unless the constructor is given
``device="cpu"``; without CUDA they raise.  Random draws come from a
`torch.Generator` or are passed in as tensors.  The streaming methods
take them as three dicts of keyword arguments: `jd_draws` for the joint
decode (`generator`, `text_gumbel`, `taste_gumbel`, each gumbel indexed by
the absolute step), `s3_draws` for the S3 decode (`generator`, `gumbel`
[max_steps, B, V+1] indexed by the absolute step) and `voc_draws` for one
vocoder window (`generator`, `z`, `source_phase`, `source_noise`).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

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
from taste_spokenlm_tpu_torch.ops.losses import IGNORE_ID
from taste_spokenlm_tpu_torch.ops.segment import (compact_valid_rows,
                                                  remap_gather,
                                                  word_start_remap)
from taste_spokenlm_tpu_torch.parallel.mesh import ModelAxis
from taste_spokenlm_tpu_torch.utils import profiling


class TasteForCausalLM(nn.Module):
    """`dtype` is the compute dtype of the speech decoder, the spoken LM and
    the voice generator; `tower_dtype` (default `dtype`) that of the audio
    tower's encoder (its segmenter and RVQ run float32 under
    `segmenter_f32`).  `model_axis` (parallel/mesh.py, e.g.
    `make_mesh(data, model).model_axis`) splits the spoken LM's Llama over
    the model group, tensor parallel as JAX's `_TP_RULES`; the tower, the
    speech decoder and the voice generator stay whole on every rank (JAX
    has no rule for them), so `synthesize_from_taste` runs alike on every
    rank.  Load it with `quant.shard_state_dict` of a full state dict."""

    def __init__(self, config: TasteConfig, dtype: torch.dtype = torch.float32,
                 tower_dtype: Optional[torch.dtype] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 weight_commit_loss: float = 1.0,
                 model_axis: Optional[ModelAxis] = None):
        super().__init__()
        self.config = config
        self.weight_commit_loss = weight_commit_loss
        self.device = resolve_device(device)
        with profiling.span("setup.construct"):
            self.audio_tower = TasteAudioTower(
                config.audio_tower, dtype=tower_dtype or dtype)
            self.speech_decoder = TasteSpeechDecoder(config.speech_decoder,
                                                     dtype=dtype)
            q = config.audio_tower.quantizer
            self.spoken_lm = TasteSpokenLM(
                config.spoken_lm, audio_dim=config.audio_tower.audio_embed_dim,
                taste_k=q.codebook_size, taste_d=q.codebook_dim,
                taste_l=q.num_quantizers, dtype=dtype, model_axis=model_axis)
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

    def forward_spoken_llm(
        self, llm_indices, llm_token_ids, llm_token_lengths, llm_word_ids,
        speaker_embeds=None, asr_token_ids=None, asr_token_lengths=None,
        asr_word_ids=None, speech_token_ids=None, speech_token_lengths=None,
        train: bool = False, eps: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None, ref_logits=None,
        compute_ref_kl: bool = False, return_text_logits: bool = True,
        ce_chunk_size: int = 64) -> Dict[str, torch.Tensor]:
        """Stage 2: the spoken LM's teacher-forced forward and losses
        (TasteSpokenLM.forward).  Given the speech targets and the asr
        inputs, the speech decoder also runs on the predicted taste (the
        eval measurement): speech_logits, speech_labels,
        speech_token_accuracy."""
        cb = self._cb()
        out = self.spoken_lm(cb, llm_indices, llm_token_ids, llm_token_lengths,
                             llm_word_ids, train=train, eps=eps,
                             generator=generator, ref_logits=ref_logits,
                             compute_ref_kl=compute_ref_kl,
                             return_text_logits=return_text_logits,
                             ce_chunk_size=ce_chunk_size)
        if speech_token_ids is not None and asr_token_ids is not None:
            audio_unit_embeds = self._taste_to_audio_embeds(
                cb, out["taste_logits"], out["taste_labels"],
                asr_token_lengths, asr_word_ids)
            decoded = self.speech_decoder(
                speaker_embeds, audio_unit_embeds, asr_token_lengths,
                asr_token_ids, asr_token_lengths, speech_token_ids,
                speech_token_lengths)
            out["speech_logits"] = decoded["logits"]
            out["speech_labels"] = decoded["labels"]
            out["speech_token_accuracy"] = decoded["speech_token_accuracy"]
        return out

    def _taste_to_audio_embeds(self, cb: Codebook, taste_logits, taste_labels,
                               asr_token_lengths, asr_word_ids):
        """The predicted taste at the labelled (delayed) positions, one row
        a word, -> per-asr-token audio embeds."""
        preds = torch.where(taste_labels != IGNORE_ID,
                            taste_logits.argmax(dim=-1),
                            torch.full_like(taste_labels, IGNORE_ID))
        valid = (taste_labels != IGNORE_ID).all(dim=-1)
        dense = compact_valid_rows(preds, valid, asr_word_ids.shape[1],
                                   pad_value=0)
        return self.spoken_lm.get_audio_embeds_from_taste(
            cb, asr_token_lengths, asr_word_ids, dense)

    @torch.no_grad()
    def scoring(self, asr_token_ids, asr_token_lengths, asr_word_ids,
                llm_token_ids, llm_token_lengths, llm_word_ids,
                audio_features) -> torch.Tensor:
        """The spoken LM's loss on the utterance's own taste (extract_vq):
        the ranking score."""
        _, llm_indices = self.extract_vq(
            asr_token_ids, asr_token_lengths, asr_word_ids, llm_token_ids,
            llm_token_lengths, llm_word_ids, audio_features)
        out = self.spoken_lm(self._cb(), llm_indices, llm_token_ids,
                             llm_token_lengths, llm_word_ids)
        return out["loss"]

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
        llm_token_ids=None, llm_token_lengths=None, llm_word_ids=None,
        sampling_k: int = 25, generator: Optional[torch.Generator] = None,
        gumbel: Optional[torch.Tensor] = None,
        z: Optional[torch.Tensor] = None,
        source_phase: Optional[torch.Tensor] = None,
        source_noise: Optional[torch.Tensor] = None,
    ) -> Dict[str, torch.Tensor]:
        """audio -> taste -> S3 tokens -> waveform.  Mode
        "SpeechAutoEncoder" takes the tower's taste embeds; "SpokenLLM"
        the spoken LM's teacher-forced prediction of the utterance's taste
        (extract_vq over the llm tokens `llm_token_ids`,
        `llm_token_lengths`, `llm_word_ids`), read back per asr token.

        `gumbel` [max_speech_steps, B, V+1] is the S3 sampling noise; `z`,
        `source_phase` and `source_noise` the voice generator's draws.  Each
        comes from `generator` when not given."""
        with profiling.span("reconstruct"):
            embeds, embed_lengths, indices = self._taste_embeds(
                mode, asr_token_ids, asr_token_lengths, asr_word_ids,
                audio_features, llm_token_ids, llm_token_lengths, llm_word_ids)
            gen = self.speech_decoder.generate(
                speaker_embeds, embeds, embed_lengths,
                asr_token_ids, asr_token_lengths,
                max_steps=max_speech_steps, sampling_k=sampling_k,
                generator=generator, gumbel=gumbel)
            tokens = torch.clamp(gen["speech_token_ids"], min=0)
            wav, wav_lengths = self.voice_generator(
                tokens, gen["speech_token_lengths"], speaker_embeds,
                mel_len_max, generator=generator, z=z,
                source_phase=source_phase, source_noise=source_noise)
        return {"quantized_indices": indices,
                "speech_token_ids": gen["speech_token_ids"],
                "speech_token_lengths": gen["speech_token_lengths"],
                "waveform": wav, "waveform_lengths": wav_lengths}

    def _taste_embeds(self, mode, asr_token_ids, asr_token_lengths,
                      asr_word_ids, audio_features, llm_token_ids,
                      llm_token_lengths, llm_word_ids):
        """inference_reconstruction's taste, under the span `tower`: ->
        (audio_unit_embeds, audio_unit_lengths, asr indices)."""
        with profiling.span("tower"):
            if mode == "SpeechAutoEncoder":
                encoded = self.audio_tower(audio_features, asr_token_ids,
                                           asr_token_lengths, asr_word_ids)
                return (encoded["audio_unit_embeds"],
                        encoded["audio_unit_lengths"],
                        encoded["quantized_indices"])
            if mode != "SpokenLLM":
                raise ValueError(mode)
            if llm_token_ids is None or llm_token_lengths is None \
                    or llm_word_ids is None:
                raise ValueError("mode 'SpokenLLM' needs llm_token_ids, "
                                 "llm_token_lengths and llm_word_ids")
            cb = self._cb()
            indices, llm_indices = self.extract_vq(
                asr_token_ids, asr_token_lengths, asr_word_ids, llm_token_ids,
                llm_token_lengths, llm_word_ids, audio_features)
            lm_out = self.spoken_lm(cb, llm_indices, llm_token_ids,
                                    llm_token_lengths, llm_word_ids)
            return (self._taste_to_audio_embeds(
                cb, lm_out["taste_logits"], lm_out["taste_labels"],
                asr_token_lengths, asr_word_ids), asr_token_lengths, indices)

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
                            generator: Union[None, torch.Generator,
                                             Sequence[torch.Generator]] = None,
                            text_gumbel: Optional[torch.Tensor] = None,
                            taste_gumbel: Optional[torch.Tensor] = None
                            ) -> Dict[str, torch.Tensor]:
        """The joint text + taste decode (the device part of the reference's
        inference_completion); `tables` maps word_start / banned /
        sentence_end to bool tensors [V] (models/sampler.py); `generator`
        one generator or one a row (TasteSpokenLM.generate)."""
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

    # ------------------------------------------------------------------
    # streaming synthesis (chunked decode + windowed vocoding)
    # ------------------------------------------------------------------

    @torch.no_grad()
    def stream_synth_init(self, speaker_embeds, taste_indices_per_word,
                          asr_token_ids, asr_token_lengths, asr_word_ids,
                          max_speech_steps: int = 512,
                          s3_draws: Optional[Dict] = None) -> Dict:
        """Streaming counterpart of synthesize_from_taste: the fused
        audio-unit prefix and the S3 prefill -> the decode stream state."""
        audio_unit_embeds = self.spoken_lm.get_audio_embeds_from_taste(
            self._cb(), asr_token_lengths, asr_word_ids, taste_indices_per_word)
        return self.speech_decoder.generate_stream_init(
            speaker_embeds, audio_unit_embeds, asr_token_lengths,
            asr_token_ids, asr_token_lengths, max_steps=max_speech_steps,
            **(s3_draws or {}))

    @torch.no_grad()
    def stream_decode_chunk(self, state, chunk_steps: int,
                            sampling_k: int = 25):
        """(tokens [B, chunk_steps] with -1 after EOS, new stream state)."""
        return self.speech_decoder.generate_stream_chunk(
            state, chunk_steps, sampling_k=sampling_k)

    @torch.no_grad()
    def stream_vocode_window(self, window_tokens, window_lengths,
                             speaker_embeds, mel_len_max: int,
                             voc_draws: Optional[Dict] = None):
        """Flow + HiFT over one token window (left context + new chunk):
        (wav [B, mel_len_max*256], wav_lengths [B])."""
        return self.voice_generator(
            torch.clamp(window_tokens, min=0), window_lengths, speaker_embeds,
            mel_len_max, **(voc_draws or {}))

    @torch.no_grad()
    def stream_step(self, state, speaker_embeds, token_hist, hist_len,
                    chunk_steps: int, window: int, mel_window_max: int,
                    sampling_k: int = 25,
                    voc_draws: Optional[Dict] = None) -> Dict:
        """Decode one S3 chunk and vocode its window.  The chunk's tokens
        (post-EOS ones as 0) go into `token_hist` at `hist_len` (in place);
        e = hist_len + n_new, where n_new is the most live tokens of a row;
        the window [ws, ws + window), ws = max(hist_len - (window -
        chunk_steps), 0), is vocoded with length e - ws.  The start indices
        are clamped into the history as JAX's dynamic slices clamp them.
        -> tokens, state, token_hist, hist_len (e), n_new, win_len [B] (the
        window's valid tokens, e - ws), wav, done, and steps_run (the decode
        steps this chunk executed, a host int)."""
        step0 = int(state["step"])
        tokens, state = self.speech_decoder.generate_stream_chunk(
            state, chunk_steps, sampling_k=sampling_k)
        b, width = token_hist.shape
        dev = token_hist.device
        n_new = (tokens >= 0).sum(dim=1).max()
        hl = torch.as_tensor(hist_len, device=dev).long()
        start = torch.clamp(hl, 0, width - chunk_steps)
        cols = (start + torch.arange(chunk_steps, device=dev))[None]
        token_hist.scatter_(1, cols.expand(b, -1),
                            torch.clamp(tokens, min=0).to(token_hist.dtype))
        e = hl + n_new
        ws = torch.clamp(hl - (window - chunk_steps), min=0)
        ws = torch.clamp(ws, max=width - window)
        win = torch.gather(token_hist, 1, (ws + torch.arange(
            window, device=dev))[None].expand(b, -1))
        win_len = (e - ws).expand(b)
        wav, _ = self.stream_vocode_window(win, win_len, speaker_embeds,
                                           mel_window_max, voc_draws)
        return {"tokens": tokens, "state": state, "token_hist": token_hist,
                "hist_len": e, "n_new": n_new, "win_len": win_len, "wav": wav,
                "done": state["done"],
                "steps_run": int(state["step"]) - step0}

    @torch.no_grad()
    def stream_start_step(self, speaker_embeds, taste_indices_per_word,
                          asr_token_ids, asr_token_lengths, asr_word_ids,
                          max_speech_steps: int, chunk_steps: int,
                          window: int, mel_window_max: int,
                          hist_pad: int = 0, sampling_k: int = 25,
                          s3_draws: Optional[Dict] = None,
                          voc_draws: Optional[Dict] = None) -> Dict:
        """stream_synth_init + the first stream_step.  `hist_pad`: the
        largest later chunk, which the token history must leave room
        for."""
        state = self.stream_synth_init(
            speaker_embeds, taste_indices_per_word, asr_token_ids,
            asr_token_lengths, asr_word_ids, max_speech_steps, s3_draws)
        hist = torch.zeros(
            (speaker_embeds.shape[0],
             max_speech_steps + max(chunk_steps, hist_pad)),
            dtype=torch.long, device=speaker_embeds.device)
        return self.stream_step(state, speaker_embeds, hist, 0, chunk_steps,
                                window, mel_window_max, sampling_k, voc_draws)

    @torch.no_grad()
    def stream_extend_step(self, speaker_embeds, taste_indices_per_word,
                           asr_token_ids, asr_token_lengths, asr_word_ids,
                           token_hist, hist_len, max_speech_steps: int,
                           chunk_steps: int, window: int, mel_window_max: int,
                           sampling_k: int = 25,
                           s3_draws: Optional[Dict] = None,
                           voc_draws: Optional[Dict] = None) -> Dict:
        """Re-prefill the S3 decoder with extended text / taste, replay the
        committed history into its KV cache, decode the next chunk and
        vocode its window.  `s3_draws` are those of the stream it
        continues: its live generator, or its gumbel, which the resumed
        decode reads from step hist_len on."""
        audio_unit_embeds = self.spoken_lm.get_audio_embeds_from_taste(
            self._cb(), asr_token_lengths, asr_word_ids, taste_indices_per_word)
        state = self.speech_decoder.generate_stream_resume(
            speaker_embeds, audio_unit_embeds, asr_token_lengths,
            asr_token_ids, asr_token_lengths, token_hist, hist_len,
            max_steps=max_speech_steps, **(s3_draws or {}))
        return self.stream_step(state, speaker_embeds, token_hist, hist_len,
                                chunk_steps, window, mel_window_max,
                                sampling_k, voc_draws)

    @torch.no_grad()
    def completion_stream_start(self, sampler_cfg: SamplerConfig, tables,
                                llm_indices, llm_token_ids, llm_token_lengths,
                                llm_word_ids, conditional_mode: str = "audio",
                                max_steps: int = 256, first_chunk: int = 16,
                                jd_draws: Optional[Dict] = None) -> Dict:
        """The joint-decode prefill and its first `first_chunk` steps."""
        st = self.spoken_lm.generate_stream_init(
            self._cb(), llm_indices, llm_token_ids, llm_token_lengths,
            llm_word_ids, conditional_mode, max_steps)
        return self.completion_stream_chunk(st, sampler_cfg, tables,
                                            first_chunk, jd_draws)

    @torch.no_grad()
    def completion_stream_chunk(self, state, sampler_cfg: SamplerConfig,
                                tables, chunk_steps: int,
                                jd_draws: Optional[Dict] = None) -> Dict:
        """Continue the joint decode by up to `chunk_steps` steps."""
        return self.spoken_lm.generate_stream_chunk(
            state, self._cb(), sampler_cfg, tables, chunk_steps,
            **(jd_draws or {}))

    @torch.no_grad()
    def completion_first_audio(
        self, sampler_cfg: SamplerConfig, tables, llm_indices, llm_token_ids,
        llm_token_lengths, llm_word_ids, speaker_embeds, asr_token_ids,
        asr_word_ids, asr_valid, conditional_mode: str = "audio",
        max_steps: int = 256, jd_first_chunk: int = 16,
        max_speech_steps: int = 512, first_chunk_tokens: int = 16,
        mel_window_first: int = 128, hist_pad: int = 0, sampling_k: int = 25,
        jd_draws: Optional[Dict] = None, s3_draws: Optional[Dict] = None,
        voc_draws: Optional[Dict] = None) -> Dict:
        """completion_stream_start + the first synthesis chunk: the
        joint-LM prefill, `jd_first_chunk` joint steps, the S3 prefill over
        the words decoded so far, `first_chunk_tokens` S3 steps and one
        small vocoder window.

        The word count (complete words only while decoding; every sampled
        taste word once done), the taste clamp and the asr lengths
        (`asr_valid` [B, Ta] masks the tokenizer's pad positions) are
        computed on the device.  The caller checks `n_words >=
        min_start_words or jd_done` on the host; when false the synthesis
        outputs came from too little text and are discarded."""
        st = self.completion_stream_start(
            sampler_cfg, tables, llm_indices, llm_token_ids,
            llm_token_lengths, llm_word_ids, conditional_mode, max_steps,
            jd_first_chunk, jd_draws)
        words = torch.minimum(st["n_taste"][0],
                              torch.clamp(st["word_id_cur"][0], min=0))
        jd_done = st["done"].all() | (st["step"] >= max_steps)
        n_words = torch.where(jd_done, st["n_taste"][0], words)
        taste = torch.clamp(st["out_taste"], min=0)
        asr_lens = ((asr_word_ids < n_words) & asr_valid).sum(dim=1)
        syn = self.stream_start_step(
            speaker_embeds, taste, asr_token_ids, asr_lens, asr_word_ids,
            max_speech_steps, first_chunk_tokens, first_chunk_tokens,
            mel_window_first, hist_pad, sampling_k, s3_draws, voc_draws)
        return {"jd_state": st, "syn": syn, "n_words": n_words,
                "jd_done": jd_done}
