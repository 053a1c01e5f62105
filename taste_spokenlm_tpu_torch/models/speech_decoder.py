"""TASTE speech decoder: (taste units + text) -> S3 speech tokens
(counterpart of the JAX models/speech_decoder.py teacher-forced forward and
inference path).

  text ids  -> embed -> causal conformer -> affine
  taste emb -> affine -> causal conformer -> affine
  fuse (softmax-weighted sum, optionally of LayerNormed streams; or the
        concat fusions [audio | text] and [audio | sep | text], packed
        raggedly, 2T (+1) long)
  prefix = [sos | spk | fused | task], packed left-padded
  KV-cached AR decode of the llm conformer -> head (V+1, last = EOS)

The teacher-forced forward (stage-1 training) packs [sos | spk | fused |
task | S3] raggedly, runs one causal pass of the llm conformer and scores
the head against [IGNORE x (2 + T) | S3 | EOS] with the label-smoothing CE
and the top-1 accuracy.  Module names follow the reference
TasteSpeechDecoder state dict; the learned separator of concat_with_sep
is fuse_encoded_audio_text_module.sep_embed.

The sampling noise of the AR decode is indexed by the absolute decode
step (`gumbel` [max_steps, B, V+1] sliced at the state's step), so a
chunked, a resumed and a one-shot decode read the same draw at the same
step.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from taste_spokenlm_tpu_torch.config import SpeechDecoderConfig
from taste_spokenlm_tpu_torch.models.conformer import ConformerEncoder
from taste_spokenlm_tpu_torch.ops.losses import (IGNORE_ID, label_smoothing_ce,
                                                 masked_accuracy)
from taste_spokenlm_tpu_torch.ops.quantized import dense
from taste_spokenlm_tpu_torch.ops.sampling import sample
from taste_spokenlm_tpu_torch.ops.segment import ragged_concat


class _Fuse(nn.Module):
    def __init__(self, init_type: str, sep_dim: int = 0):
        super().__init__()
        init = {"balance": [1.0, 1.0], "zero_audio": [-2.0, 2.0]}[init_type]
        self.weights = nn.Parameter(torch.tensor(init))
        if sep_dim:
            self.sep_embed = nn.Parameter(torch.zeros(sep_dim))


def _layer_norm_no_affine(x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + 1e-5)).to(x.dtype)


class TasteSpeechDecoder(nn.Module):
    def __init__(self, config: SpeechDecoderConfig,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = self.config = config
        if cfg.fuse_type not in ("weighted_sum", "concat", "concat_with_sep"):
            raise ValueError(f"fuse_type {cfg.fuse_type!r}")
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
        self.fuse_encoded_audio_text_module = _Fuse(
            cfg.fuse_weight_init_type,
            cfg.llm_input_size if cfg.fuse_type == "concat_with_sep" else 0)
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
        """weighted_sum: the softmax-weighted sum of the two streams (each
        LayerNormed without affine first under `fuse_normalize`), at the
        aligned length.  concat / concat_with_sep: [audio | (sep) | text]
        of each row's valid rows, packed to 2T (+1) columns, and the packed
        lengths."""
        cfg = self.config
        mod = self.fuse_encoded_audio_text_module
        if cfg.fuse_type == "weighted_sum":
            if cfg.fuse_normalize:
                audio_encoded = _layer_norm_no_affine(audio_encoded)
                text_encoded = _layer_norm_no_affine(text_encoded)
            w = torch.softmax(mod.weights.float(), dim=0)
            fused = w[0] * audio_encoded.float() + w[1] * text_encoded.float()
            return fused.to(self.dtype), lengths
        b, t = audio_encoded.shape[:2]
        segments = [(audio_encoded, lengths)]
        if cfg.fuse_type == "concat_with_sep":
            segments.append((mod.sep_embed[None, None, :].expand(b, 1, -1)
                             .to(audio_encoded.dtype), None))
        segments.append((text_encoded, lengths))
        return ragged_concat(segments, 2 * t + len(segments) - 2)

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
    # training forward
    # ------------------------------------------------------------------

    def forward(self, speaker_embeds, audio_unit_embeds, audio_unit_lengths,
                asr_token_ids, asr_token_lengths, speech_token_ids,
                speech_token_lengths, skip_audio: bool = False
                ) -> Dict[str, torch.Tensor]:
        """Teacher-forced S3 prediction: -> loss, logits [B, 3+T+S, V+1],
        labels and speech_token_accuracy.  Rows with no speech tokens carry
        no target at all, not even the EOS."""
        cfg = self.config
        b = asr_token_ids.shape[0]
        s = speech_token_ids.shape[1]
        dev = asr_token_ids.device
        sos, spk, fused, task, fused_lengths = self.prepare_conditional_embeds(
            speaker_embeds, audio_unit_embeds, audio_unit_lengths,
            asr_token_ids, asr_token_lengths, skip_audio)
        speech_emb = self.speech_embedding(speech_token_ids.long())
        tf = fused.shape[1]
        out_len = 3 + tf + s
        lm_input, lm_len = ragged_concat(
            [(sos, None), (spk, None), (fused, fused_lengths), (task, None),
             (speech_emb, speech_token_lengths)], out_len)
        ign = torch.full((b, 2 + tf), IGNORE_ID, dtype=torch.long, device=dev)
        eos = torch.where(speech_token_lengths > 0, cfg.speech_token_size,
                          IGNORE_ID).long()[:, None]
        lm_target, _ = ragged_concat(
            [(ign, fused_lengths + 2), (speech_token_ids.long(),
                                        speech_token_lengths), (eos, None)],
            out_len, pad_value=IGNORE_ID)
        lm_out = self.llm(lm_input, lm_len)
        logits = self.llm_decoder(lm_out)
        loss = label_smoothing_ce(logits, lm_target, smoothing=cfg.lsm_weight,
                                  normalize_length=cfg.length_normalized_loss)
        return {"loss": loss, "logits": logits, "labels": lm_target,
                "speech_token_accuracy": masked_accuracy(logits, lm_target)}

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
                             generator: Optional[torch.Generator] = None,
                             gumbel: Optional[torch.Tensor] = None
                             ) -> Dict[str, Any]:
        """Pack + prefill; returns the stream state for
        `generate_stream_chunk`, which draws its noise from `generator` or
        reads it from `gumbel` [max_steps, B, V+1]."""
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
        return {"step": 0, "generator": generator, "gumbel": gumbel,
                "caches": caches,
                "hidden": lm_out[:, -1], "done": torch.zeros(
                    (b,), dtype=torch.bool, device=dev),
                "key_valid": key_valid, "min_len": min_len, "max_len": max_len,
                "prefix_max": prefix_max, "pos_projs": pos_projs}

    @torch.no_grad()
    def generate_stream_chunk(self, state: Dict[str, Any], chunk_steps: int,
                              sampling_k: int = 25):
        """Decode up to `chunk_steps` tokens; returns (tokens [B, chunk_steps]
        with -1 after EOS, new state).  Stops early once every row is done.
        Step s of the decode reads the state's gumbel[s], whichever chunk
        runs it, or draws from its generator."""
        cfg = self.config
        gumbel = state["gumbel"]
        b = state["hidden"].shape[0]
        dev = state["hidden"].device
        eos = cfg.speech_token_size
        tokens = torch.full((b, chunk_steps), -1, dtype=torch.long, device=dev)
        step, hidden, done = state["step"], state["hidden"], state["done"]
        kv = state["key_valid"][:, None, None, :]
        max_steps = state["key_valid"].shape[1] - state["prefix_max"]
        for i in range(chunk_steps):
            if bool(done.all()):
                break
            if step >= max_steps:
                # every row is past its max_len (<= max_steps): the step
                # would emit -1 and stop them, with no cache slot to write
                done = torch.ones_like(done)
                break
            logits = self.llm_decoder(hidden).float()
            forbid = step < state["min_len"]
            ids = sample(logits, top_k=sampling_k, forbid_eos=forbid,
                         eos_id=eos, generator=state["generator"],
                         gumbel=None if gumbel is None else gumbel[step])
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
    def generate_stream_resume(self, speaker_embeds, audio_unit_embeds,
                               audio_unit_lengths, asr_token_ids,
                               asr_token_lengths, hist_tokens, hist_len,
                               max_steps: int = 512,
                               min_token_text_ratio: float = 2.0,
                               max_token_text_ratio: float = 20.0,
                               skip_audio: bool = False,
                               generator: Optional[torch.Generator] = None,
                               gumbel: Optional[torch.Tensor] = None
                               ) -> Dict[str, Any]:
        """Re-prefill with (possibly extended) text / taste conditioning and
        replay a committed history `hist_tokens` [B, >= max_steps] of
        `hist_len` tokens into the KV cache: -> a stream state at step
        `hist_len`, ready for `generate_stream_chunk`.

        The replay is one multi-token cached decode of the fixed
        hist[:, :max_steps] rows at index prefix_max; rows past hist_len
        write slots that the causal mask hides and that each later step
        overwrites first.  The hidden state is the one after the last
        committed token (the prefill's when hist_len is 0).  With the same
        text, resume + chunk continues the uninterrupted stream: the noise
        is indexed by the absolute step (`gumbel` [max_steps, B, V+1]), or
        `generator` is the live generator of the stream this one
        continues."""
        cfg = self.config
        state = self.generate_stream_init(
            speaker_embeds, audio_unit_embeds, audio_unit_lengths,
            asr_token_ids, asr_token_lengths, max_steps=max_steps,
            min_token_text_ratio=min_token_text_ratio,
            max_token_text_ratio=max_token_text_ratio, skip_audio=skip_audio,
            generator=generator, gumbel=gumbel)
        hist_len = int(hist_len)
        hist = hist_tokens[:, :max_steps].long()
        emb = self.speech_embedding(
            torch.clamp(hist, 0, cfg.speech_token_size - 1))
        lm_out, caches = self.llm.decode_step(
            emb, state["caches"], state["prefix_max"],
            key_valid=state["key_valid"][:, None, None, :],
            pos_projs=state["pos_projs"])
        hidden = (lm_out[:, hist_len - 1] if hist_len > 0
                  else state["hidden"])
        return dict(state, caches=caches, hidden=hidden, step=hist_len)

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
            generator=generator, gumbel=gumbel)
        tokens, _ = self.generate_stream_chunk(state, max_steps,
                                               sampling_k=sampling_k)
        return {"speech_token_ids": tokens,
                "speech_token_lengths": (tokens >= 0).sum(dim=1)}
