"""TasteSpokenLM, the joint text + taste autoregressive LM (counterpart of
the JAX models/spoken_lm.py).

Ported: the word / token / no-delay conditional prefix
(`prepare_conditional_embeds`, audio embeds by every
`audio_embed_conv_mode`: `fill_forward`, `pad`, `embed_a0_only`,
`get_codes_from_indices`), the
teacher-forced forward with its losses (`forward`: text CE, optionally
with the KL to the frozen base, and the taste loss), the KV-cached joint
decode in the modes zero / text / audio / instruct
(`generate_stream_init`, `generate_stream_chunk`, `generate`) with the
branchless sampler (models/sampler.py), and `get_audio_embeds_from_taste`,
with every in- and out-bridge of models/bridges.py but the `reference_mix`
extraction, which JAX's spoken LM cannot run either.  The weighted-layer
bridges read every hidden state of the Llama, in the forward and at each
decode step.
The decode is a Python loop over steps; it stops early once every row is
done, as the JAX while-loop does.

Built with a `model_axis`, the Llama is split over the model group
(models/llama.py) and everything else is replicated: every rank gets the
same full logits from the head, so every rank runs the sampler, the
bridges and the decode's bookkeeping alike and, with generators seeded
alike, decodes the same trajectory.

Random draws are Gumbel noise: per step a [B, V] text draw and a
[B, L, K] taste draw, taken from `generator` or from the `text_gumbel`
[max_steps, B, V] / `taste_gumbel` [max_steps, B, L, K] arguments (step s
of the decode reads row s, whichever chunk runs it), and only where the
sampler samples (top_p > 0).  `generator` may be one generator or a
sequence of B: row i's draws then come from generator i alone, one text
and one taste draw a step, so a row's trajectory does not depend on the
rows decoded beside it (the JAX decode's fold_in(row key, step) contract,
which the serving batcher's per-request seeds rely on).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from taste_spokenlm_tpu_torch.config import SpokenLMConfig
from taste_spokenlm_tpu_torch.models.bridges import make_extract, make_fusion
from taste_spokenlm_tpu_torch.models.llama import LlamaModel
from taste_spokenlm_tpu_torch.models.quantizer import (
    Codebook, codebook_code_from_indices, codebook_output_from_indices)
from taste_spokenlm_tpu_torch.models.sampler import (IGNORE_ID, SamplerConfig,
                                                     init_state, sampler_step)
from taste_spokenlm_tpu_torch.ops.losses import chunked_ce_kl, kl_to_reference
from taste_spokenlm_tpu_torch.ops.masking import length_mask
from taste_spokenlm_tpu_torch.ops.sampling import gumbel_noise
from taste_spokenlm_tpu_torch.ops.segment import ragged_concat, word_start_mask
from taste_spokenlm_tpu_torch.parallel import mesh


def fill_forward_indices(indices: torch.Tensor) -> torch.Tensor:
    """[B, T, L]: rows that are all -1 take the last previous valid row;
    rows before the first valid one stay -1."""
    b, t, l = indices.shape
    valid = (indices != IGNORE_ID).all(dim=-1)
    pos = torch.where(valid, torch.arange(t, device=indices.device)[None, :],
                      torch.full_like(valid, -1, dtype=torch.long))
    last = torch.cummax(pos, dim=1).values
    filled = torch.gather(indices, 1, last.clamp(min=0)[:, :, None].expand(-1, -1, l))
    return torch.where((last >= 0)[:, :, None], filled,
                       torch.full_like(filled, IGNORE_ID))


def word_start_positions(word_ids: torch.Tensor, lengths: torch.Tensor):
    """[B, T] word ids -> (start_pos [B, T]: position of word w's first
    token, 0 where w >= the word count; word_count [B])."""
    t = word_ids.shape[1]
    ws = word_start_mask(word_ids, lengths)
    onehot = (word_ids[:, :, None] == torch.arange(t, device=word_ids.device)
              [None, None, :]) & ws[:, :, None]
    start_pos = (onehot.long() * torch.arange(t, device=word_ids.device)
                 [None, :, None]).sum(dim=1)
    return start_pos, ws.sum(dim=1)


def _take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, T, ...] gathered along T by idx [B, S] -> [B, S, ...]."""
    shape = idx.shape + x.shape[2:]
    return torch.gather(x, 1, idx.reshape(*idx.shape, *([1] * (x.dim() - 2)))
                        .expand(shape))


class TasteSpokenLM(nn.Module):
    def __init__(self, config: SpokenLMConfig, audio_dim: int = 1280,
                 taste_k: int = 512, taste_d: int = 256, taste_l: int = 4,
                 dtype: torch.dtype = torch.float32,
                 model_axis: Optional[mesh.ModelAxis] = None):
        super().__init__()
        cfg = self.config = config
        if cfg.out_llm_module == "reference_mix":
            raise ValueError("out_llm_module 'reference_mix' reads taste "
                             "embeds the spoken LM does not pass (JAX's "
                             "raises on it too)")
        mode = cfg.audio_embed_conv_mode
        if mode not in ("fill_forward", "pad", "embed_a0_only",
                        "get_codes_from_indices"):
            raise ValueError(f"audio_embed_conv_mode {mode!r}")
        self.dtype, self.audio_dim, self.taste_l = dtype, audio_dim, taste_l
        h = cfg.llama.hidden_size
        self.language_model = LlamaModel(
            cfg.llama, cfg.lora if cfg.use_lora else None, dtype, model_axis)
        self.fuse_for_bridge_in_llm = make_fusion(cfg.in_llm_module, h, audio_dim)
        self.extract_for_bridge_out_llm = make_extract(
            cfg.out_llm_module, h, taste_k, taste_d, taste_l,
            cfg.llama.num_hidden_layers + 1)
        if cfg.delay > 0:
            self.pad_text_unit_embed = nn.Parameter(torch.zeros(h))
        self.pad_audio_unit_embed = nn.Parameter(torch.zeros(audio_dim))
        if mode != "fill_forward":
            self.empty_audio_unit_embed = nn.Parameter(torch.zeros(audio_dim))
        if mode == "embed_a0_only":
            self.a0_embedding = nn.Embedding(taste_k, audio_dim).to(dtype)
        if mode == "get_codes_from_indices":
            self.code_linear = nn.Linear(taste_d, audio_dim).to(dtype)
        self.fuse_for_bridge_in_llm.to(dtype)
        self.extract_for_bridge_out_llm.to(dtype)
        self.taste_d = taste_d
        # the latent heads take the regression + KL taste loss, the others
        # (multi-head ones too) the per-level CE
        self.do_continue = "continue_latent" in cfg.out_llm_module
        self.do_multihead = "multi_" in cfg.out_llm_module
        self.needs_hidden_states = \
            self.extract_for_bridge_out_llm.needs_hidden_states

    def encode_audio(self, llm_indices: torch.Tensor, cb: Codebook):
        """Per-position taste indices [B, T, L] -> audio embeds [B, T, A]
        (f32).  fill_forward: the last valid row carried forward, the pad
        embed before the first; pad: the RVQ output; embed_a0_only: a
        learned embedding of level 0's index; get_codes_from_indices: a
        linear map of the summed codebook codes.  In the last three a row
        with an invalid index takes the empty embed."""
        mode = self.config.audio_embed_conv_mode
        if mode == "fill_forward":
            filled = fill_forward_indices(llm_indices)
            emb = codebook_output_from_indices(cb, filled.clamp(min=0))
            return torch.where((filled[..., 0] >= 0)[..., None], emb.float(),
                               self.pad_audio_unit_embed.float()[None, None, :])
        valid = (llm_indices >= 0).all(dim=-1)
        zeroed = llm_indices.clamp(min=0)
        if mode == "pad":
            emb = codebook_output_from_indices(cb, zeroed)
        elif mode == "embed_a0_only":
            valid = llm_indices[..., 0] >= 0
            emb = self.a0_embedding(zeroed[..., 0].long())
        else:
            code = codebook_code_from_indices(cb, zeroed)
            emb = self.code_linear(code.to(self.code_linear.weight.dtype))
        return torch.where(valid[..., None], emb.float(),
                           self.empty_audio_unit_embed.float()[None, None, :])

    def _embed(self, ids: torch.Tensor) -> torch.Tensor:
        return self.language_model.embed_tokens(ids).to(self.dtype)

    def _fuse(self, text, audio):
        return self.fuse_for_bridge_in_llm(text.to(self.dtype),
                                           audio.to(self.dtype))

    def _pad_rows(self, param: torch.Tensor, b: int, n: int) -> torch.Tensor:
        return param[None, None, :].expand(b, n, -1)

    def prepare_conditional_embeds(self, cb: Codebook, llm_indices,
                                   llm_token_ids, llm_token_lengths,
                                   llm_word_ids):
        """-> (inputs_embeds [B, 1+T+D, H], output_lengths [B],
        taste_labels [B, 1+T+D, L], delayed audio embeds [B, T+D, A])."""
        cfg = self.config
        d = cfg.delay
        b, t = llm_token_ids.shape
        l = llm_indices.shape[-1]
        dev = llm_token_ids.device
        sos = self._embed(torch.full((b, 1), cfg.sos_id, device=dev))
        ign = lambda n: torch.full((b, n, l), IGNORE_ID, device=dev)  # noqa: E731
        if d == 0:
            audio = self.encode_audio(llm_indices[:, :-1], cb)
            fused = self._fuse(self._embed(llm_token_ids[:, :-1]), audio)
            valid = length_mask(llm_token_lengths, t)
            labels = torch.where(valid[:, :, None], llm_indices.long(),
                                 torch.full_like(llm_indices.long(), IGNORE_ID))
            return (torch.cat([sos.float(), fused], dim=1), llm_token_lengths,
                    labels, audio)
        text_stream, _ = ragged_concat(
            [(self._embed(llm_token_ids), llm_token_lengths),
             (self._pad_rows(self.pad_text_unit_embed.to(self.dtype), b, d),
              None)], t + d)
        if cfg.delay_level == "token":
            audio = self.encode_audio(llm_indices, cb)
            audio_stream, _ = ragged_concat(
                [(self._pad_rows(self.pad_audio_unit_embed.float(), b, d), None),
                 (audio, llm_token_lengths)], t + d)
            labels, _ = ragged_concat(
                [(ign(d), None), (llm_indices.long(), llm_token_lengths),
                 (ign(1), None)], 1 + t + d, pad_value=IGNORE_ID)
        elif cfg.delay_level == "word":
            ws = word_start_mask(llm_word_ids, llm_token_lengths)
            start_pos, n_words = word_start_positions(llm_word_ids,
                                                      llm_token_lengths)
            src_word = llm_word_ids.long() - d
            src_ok = ws & (src_word >= 0)
            src_tok = torch.gather(start_pos, 1, src_word.clamp(min=0))
            pre = torch.where(src_ok[:, :, None], _take_rows(llm_indices, src_tok),
                              torch.full_like(llm_indices, IGNORE_ID))
            pre = torch.where(length_mask(llm_token_lengths, t)[:, :, None], pre,
                              torch.full_like(pre, IGNORE_ID))
            wi = n_words[:, None] - d + torch.arange(d, device=dev)[None, :]
            post_tok = torch.gather(start_pos, 1, wi.clamp(min=0))
            post = torch.where((wi >= 0)[:, :, None],
                               _take_rows(llm_indices, post_tok),
                               torch.full_like(llm_indices[:, :d], IGNORE_ID))
            emb_pre = self.encode_audio(pre, cb)
            if cfg.audio_embed_conv_mode != "fill_forward":
                # rows before the first delayed word start take the pad
                # embed in every mode (fill_forward does so itself)
                before = torch.cumsum(src_ok.long(), dim=1) == 0
                emb_pre = torch.where(
                    before[:, :, None],
                    self.pad_audio_unit_embed.float()[None, None, :], emb_pre)
            audio_stream, _ = ragged_concat(
                [(emb_pre, llm_token_lengths),
                 (self.encode_audio(post, cb), None)], t + d)
            labels, _ = ragged_concat(
                [(pre.long(), llm_token_lengths), (post.long(), None),
                 (ign(1), None)], 1 + t + d, pad_value=IGNORE_ID)
        else:
            raise ValueError(f"delay_level {cfg.delay_level!r}")
        fused = self._fuse(text_stream, audio_stream)
        return (torch.cat([sos.float(), fused], dim=1), llm_token_lengths + d + 1,
                labels, audio_stream)

    # ------------------------------------------------------------------
    # the teacher-forced forward (training, eval and scoring)
    # ------------------------------------------------------------------

    def forward(self, cb: Codebook, llm_indices, llm_token_ids,
                llm_token_lengths, llm_word_ids, train: bool = False,
                eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                ref_logits: Optional[torch.Tensor] = None,
                compute_ref_kl: bool = False, return_text_logits: bool = True,
                ce_chunk_size: int = 64) -> Dict[str, torch.Tensor]:
        """The teacher-forced forward over [sos | fused text + taste] ->
        text_labels, taste_logits, taste_labels, output_lengths,
        text_loss, taste_loss, loss (and text_logits, text_kl).

        `train` reparameterises the continue-latent bridge with `eps`
        [B, 1+T+D, d] or draws from `generator`.  `compute_ref_kl` (with no
        `ref_logits`) runs the frozen base, adapters off and under no_grad,
        over [sos | tokens] as the KL's teacher.  `return_text_logits=False`
        is the training path: CE (+ KL) in time chunks of
        `ce_chunk_size` (ops/losses.chunked_ce_kl), so the [B, T, V] logits
        never exist; otherwise the full logits are returned."""
        cfg = self.config
        lm = self.language_model
        b, t = llm_token_ids.shape
        inputs_embeds, output_lengths, taste_labels, _ = \
            self.prepare_conditional_embeds(cb, llm_indices, llm_token_ids,
                                            llm_token_lengths, llm_word_ids)
        ref_hidden = None
        if compute_ref_kl and ref_logits is None:
            ref_ids = torch.cat([torch.full((b, 1), cfg.sos_id,
                                            dtype=llm_token_ids.dtype,
                                            device=llm_token_ids.device),
                                 llm_token_ids], dim=1)
            with torch.no_grad():
                hid = lm(input_ids=ref_ids,
                         attention_lengths=llm_token_lengths + 1,
                         disable_lora=True)["last_hidden"]
                if return_text_logits:
                    ref_logits = lm.logits(hid)
                else:
                    ref_hidden = hid
        out = lm(inputs_embeds=inputs_embeds, attention_lengths=output_lengths,
                 output_hidden_states=self.needs_hidden_states)
        taste_logits, info = self.extract_for_bridge_out_llm(
            out["last_hidden"], cb, train=train, eps=eps, generator=generator,
            hidden_states=out.get("hidden_states"))

        # next-token text targets, IGNORE_ID from each row's length on
        total = inputs_embeds.shape[1]
        pos = torch.arange(total, device=llm_token_ids.device)[None, :]
        padded = F.pad(llm_token_ids.long(), (0, total - t))
        text_labels = torch.where(pos < llm_token_lengths[:, None], padded,
                                  torch.full_like(padded, IGNORE_ID))
        result = {"text_labels": text_labels, "taste_logits": taste_logits,
                  "taste_labels": taste_labels,
                  "output_lengths": output_lengths}

        w = [float(x) for x in cfg.loss_weights.split("-")]
        valid = text_labels != IGNORE_ID
        if not return_text_logits:
            # every label sits inside the teacher's [sos | tokens] span, so
            # padding its hidden state to `total` touches masked rows only
            if ref_hidden is not None:
                ref_hidden = F.pad(ref_hidden,
                                   (0, 0, 0, total - ref_hidden.shape[1]))
            text_ce, kl = chunked_ce_kl(lm.logits, out["last_hidden"],
                                        text_labels, ref_hidden=ref_hidden,
                                        ref_logits=ref_logits,
                                        chunk_size=ce_chunk_size)
        else:
            text_logits = lm.logits(out["last_hidden"])
            result["text_logits"] = text_logits
            logp = torch.log_softmax(text_logits.float(), dim=-1)
            nll = -torch.gather(logp, -1,
                                text_labels.clamp(min=0)[..., None])[..., 0]
            text_ce = (torch.where(valid, nll, torch.zeros_like(nll)).sum()
                       / torch.clamp(valid.sum(), min=1))
            kl = None
            if ref_logits is not None:
                tr = ref_logits.shape[1]
                kl = kl_to_reference(text_logits[:, :tr], ref_logits,
                                     valid[:, :tr])
        if kl is not None:
            text_loss = (cfg.text_kl_weight * kl
                         + (1.0 - cfg.text_kl_weight) * text_ce)
            result["text_kl"] = kl
        else:
            text_loss = text_ce

        taste_valid = (taste_labels != IGNORE_ID).all(dim=-1)
        if self.do_continue:
            z, mu, logvar = info["z"], info["mu"], info["logvar"]
            target = codebook_code_from_indices(cb, taste_labels.clamp(min=0))
            maskf = taste_valid[..., None].float()
            denom = torch.clamp(mesh.global_sum(maskf.sum()) * self.taste_d,
                                min=1.0)
            l_reg = ((z - target) ** 2 * maskf).sum() / denom
            l_kl = 0.5 * ((torch.exp(logvar) + (mu - target) ** 2 - 1 - logvar)
                          .mean(dim=-1) * taste_valid).sum() / torch.clamp(
                              mesh.global_sum(taste_valid.sum()).float(),
                              min=1.0)
            taste_loss = 0.5 * l_reg + 0.5 * l_kl
        else:
            logp_t = torch.log_softmax(taste_logits.float(), dim=-1)
            nll_t = -torch.gather(logp_t, -1,
                                  taste_labels.clamp(min=0)[..., None])[..., 0]
            level_valid = taste_labels != IGNORE_ID
            taste_loss = (torch.where(level_valid, nll_t,
                                      torch.zeros_like(nll_t)).sum()
                          / torch.clamp(mesh.global_sum(level_valid.sum()),
                                        min=1))
        result["text_loss"] = text_loss
        result["taste_loss"] = taste_loss
        result["loss"] = w[0] * text_loss + w[1] * taste_loss
        return result

    # ------------------------------------------------------------------
    # joint decode
    # ------------------------------------------------------------------

    @torch.no_grad()
    def generate_stream_init(self, cb: Codebook, llm_indices=None,
                             llm_token_ids=None, llm_token_lengths=None,
                             llm_word_ids=None, conditional_mode: str = "audio",
                             max_steps: int = 256, instruct_prefix_ids=None,
                             instruct_suffix_ids=None, batch_size: int = 1
                             ) -> Dict[str, Any]:
        """Build the conditional prefix, prefill the KV cache and return the
        decode state for `generate_stream_chunk`.  Cache layout: prefix
        rows in slots [0, max_prefix) (left-aligned, per-row valid length),
        generated token i in slot max_prefix + i for every row; rope
        positions stay logical (prefix_len + i)."""
        cfg = self.config
        d = cfg.delay
        dev = self.pad_audio_unit_embed.device
        t = llm_token_ids.shape[1] if llm_token_ids is not None else 0
        b = llm_token_ids.shape[0] if llm_token_ids is not None else batch_size
        zeros_pending = lambda n: torch.zeros(  # noqa: E731
            (b, n, self.audio_dim), device=dev)
        pending_start = torch.zeros((b,), dtype=torch.long, device=dev)
        if conditional_mode == "audio":
            prefix, _, _, pending = self.prepare_conditional_embeds(
                cb, llm_indices, llm_token_ids, llm_token_lengths, llm_word_ids)
            prefix_len = llm_token_lengths.long() + 1
            pending_start = prefix_len - 1
        elif conditional_mode == "text":
            prefix = self._embed(llm_token_ids)
            pending = zeros_pending(t + d)
            prefix_len = llm_token_lengths.long()
        elif conditional_mode == "zero":
            prefix = self._embed(torch.full((b, 1), cfg.sos_id, device=dev))
            pending = zeros_pending(1 + d)
            prefix_len = torch.ones((b,), dtype=torch.long, device=dev)
        elif conditional_mode == "instruct":
            embeds, _, _, _ = self.prepare_conditional_embeds(
                cb, llm_indices, llm_token_ids, llm_token_lengths, llm_word_ids)
            pre = self._embed(instruct_prefix_ids)[None].expand(b, -1, -1)
            suf = self._embed(instruct_suffix_ids)[None].expand(b, -1, -1)
            prefix, _ = ragged_concat(
                [(pre.float(), None), (embeds[:, 1:1 + t], llm_token_lengths),
                 (suf.float(), None)], pre.shape[1] + t + suf.shape[1])
            prefix_len = pre.shape[1] + llm_token_lengths.long() + suf.shape[1]
            pending = zeros_pending(t + d)
        else:
            raise NotImplementedError(conditional_mode)

        lm = self.language_model
        max_prefix = prefix.shape[1]
        total = max_prefix + max_steps
        caches = lm.init_cache(b, total)
        slot = torch.arange(total, device=dev)
        key_valid0 = slot[None, :] < prefix_len[:, None]
        out0 = lm(inputs_embeds=prefix, caches=caches, cache_index=0,
                  key_valid=key_valid0,
                  output_hidden_states=self.needs_hidden_states)
        last = (prefix_len - 1)[:, None]
        hidden = _take_rows(out0["last_hidden"], last)[:, 0]
        all_hidden = (tuple(_take_rows(h, last)[:, 0]
                            for h in out0["hidden_states"])
                      if self.needs_hidden_states else None)

        sampler = init_state(b, cfg.llama.vocab_size, d, dev)
        if conditional_mode != "zero":
            counts = sampler.token_counts.clone()
            ids = llm_token_ids.long().clamp(min=0)
            counts.scatter_add_(1, ids, length_mask(llm_token_lengths, t).long())
            if conditional_mode == "instruct":
                for extra in (instruct_prefix_ids, instruct_suffix_ids):
                    counts.scatter_add_(1, extra.long()[None].expand(b, -1),
                                        torch.ones((b, extra.numel()),
                                                   dtype=torch.long, device=dev))
            sampler = sampler._replace(token_counts=counts)
        return {
            "step": 0, "caches": caches, "hidden": hidden,
            "all_hidden": all_hidden, "sampler": sampler,
            "last_audio_embed": torch.zeros((b, self.audio_dim), device=dev),
            "pending_ptr": pending_start,
            "out_tokens": torch.full((b, max_steps), IGNORE_ID, device=dev),
            "out_taste": torch.full((b, max_steps, self.taste_l), IGNORE_ID,
                                    device=dev),
            "out_words": torch.full((b, max_steps), IGNORE_ID, device=dev),
            "n_out": torch.zeros((b,), dtype=torch.long, device=dev),
            "n_taste": torch.zeros((b,), dtype=torch.long, device=dev),
            "word_id_cur": torch.full((b,), -1, device=dev),
            "done": torch.zeros((b,), dtype=torch.bool, device=dev),
            "key_valid0": key_valid0, "prefix_len": prefix_len,
            "pending": pending.float(), "max_prefix": max_prefix,
        }

    @torch.no_grad()
    def generate_stream_chunk(self, state: Dict[str, Any], cb: Codebook,
                              sampler_cfg: SamplerConfig, tables,
                              chunk_steps: int,
                              generator: Union[None, torch.Generator,
                                               Sequence[torch.Generator]] = None,
                              text_gumbel: Optional[torch.Tensor] = None,
                              taste_gumbel: Optional[torch.Tensor] = None
                              ) -> Dict[str, Any]:
        """Decode up to `chunk_steps` joint steps; out_tokens / out_taste /
        out_words accumulate across chunks.  Stops early once every row is
        done.  `tables`: bool tensors [V] on the model's device."""
        lm = self.language_model
        st = dict(state)
        b, max_steps = st["out_tokens"].shape
        dev = st["hidden"].device
        rows = torch.arange(b, device=dev)
        slot = torch.arange(st["key_valid0"].shape[1], device=dev)
        max_prefix, pending = st["max_prefix"], st["pending"]
        v = self.config.llama.vocab_size
        pad_audio = self.pad_audio_unit_embed.float()[None]
        for i in range(chunk_steps):
            step = st["step"]
            if step >= max_steps or bool(st["done"].all()):
                break
            text_logits = lm.logits(st["hidden"][:, None])[:, 0]
            taste_logits, _ = self.extract_for_bridge_out_llm(
                st["hidden"][:, None].float(), cb, hidden_states=(
                    None if st["all_hidden"] is None
                    else tuple(h[:, None] for h in st["all_hidden"])))
            taste_logits = taste_logits[:, 0]
            noise = [None, None]
            for j, (p, given, shape) in enumerate((
                    (sampler_cfg.text_top_p, text_gumbel, (b, v)),
                    (sampler_cfg.taste_top_p, taste_gumbel,
                     tuple(taste_logits.shape)))):
                if p > 0:
                    noise[j] = (given[step].to(dev) if given is not None
                                else gumbel_noise(shape, generator, dev))
            sampler, out = sampler_step(st["sampler"], text_logits,
                                        taste_logits, sampler_cfg, tables,
                                        noise[0], noise[1])
            live = ~st["done"]
            n_out, n_taste = st["n_out"], st["n_taste"]
            emit = out.emit_text & live
            out_tokens = st["out_tokens"].clone()
            out_tokens[rows, n_out] = torch.where(emit, out.text_id,
                                                  out_tokens[rows, n_out])
            word_id_cur = st["word_id_cur"] + (emit & out.is_word_start).long()
            out_words = st["out_words"].clone()
            out_words[rows, n_out] = torch.where(emit, word_id_cur,
                                                 out_words[rows, n_out])
            do_taste = out.taste_sample & live
            out_taste = st["out_taste"].clone()
            out_taste[rows, n_taste] = torch.where(
                do_taste[:, None], out.taste_ids, out_taste[rows, n_taste])

            taste_embed = codebook_output_from_indices(
                cb, out.taste_ids.clamp(min=0)[:, None])[:, 0].float()
            prefix_audio = pending[rows, st["pending_ptr"].clamp(
                max=pending.shape[1] - 1)]
            last_audio = torch.where(
                do_taste[:, None], taste_embed,
                torch.where(out.use_prefix[:, None], prefix_audio,
                            st["last_audio_embed"]))
            started = out.taste_started | bool(sampler_cfg.has_prefix)
            audio_embed = torch.where(started[:, None], last_audio, pad_audio)
            fused = self._fuse(self._embed(out.text_id[:, None]),
                               audio_embed[:, None])
            gen_valid = (slot >= max_prefix) & (slot < max_prefix + step + 1)
            out_step = lm(inputs_embeds=fused, caches=st["caches"],
                          cache_index=max_prefix + step,
                          position_offset=st["prefix_len"] + step,
                          key_valid=st["key_valid0"] | gen_valid[None],
                          output_hidden_states=self.needs_hidden_states)
            st.update(
                step=step + 1, hidden=out_step["last_hidden"][:, 0],
                all_hidden=(tuple(h[:, 0] for h in out_step["hidden_states"])
                            if self.needs_hidden_states else None),
                sampler=sampler, last_audio_embed=last_audio,
                pending_ptr=st["pending_ptr"] + out.use_prefix.long(),
                out_tokens=out_tokens, out_taste=out_taste,
                out_words=out_words, n_out=n_out + emit.long(),
                n_taste=n_taste + do_taste.long(), word_id_cur=word_id_cur,
                done=st["done"] | out.terminate)
        return st

    @torch.no_grad()
    def generate(self, cb: Codebook, sampler_cfg: SamplerConfig, tables,
                 llm_indices=None, llm_token_ids=None, llm_token_lengths=None,
                 llm_word_ids=None, conditional_mode: str = "audio",
                 max_steps: int = 256, instruct_prefix_ids=None,
                 instruct_suffix_ids=None, batch_size: int = 1,
                 generator: Union[None, torch.Generator,
                                  Sequence[torch.Generator]] = None,
                 text_gumbel: Optional[torch.Tensor] = None,
                 taste_gumbel: Optional[torch.Tensor] = None
                 ) -> Dict[str, torch.Tensor]:
        """Batched joint decode: llm token ids [B, max_steps], word ids, per-
        word taste indices [B, max_steps, L] (dense), per-row counts and
        the number of decode steps taken."""
        st = self.generate_stream_init(
            cb, llm_indices, llm_token_ids, llm_token_lengths, llm_word_ids,
            conditional_mode, max_steps, instruct_prefix_ids,
            instruct_suffix_ids, batch_size)
        st = self.generate_stream_chunk(st, cb, sampler_cfg, tables, max_steps,
                                        generator, text_gumbel, taste_gumbel)
        return {"llm_token_ids": st["out_tokens"],
                "llm_word_ids": st["out_words"],
                "taste_indices": st["out_taste"],
                "num_tokens": st["n_out"], "num_taste_words": st["n_taste"],
                "steps": st["step"]}

    def get_audio_embeds_from_taste(self, cb: Codebook, asr_token_lengths,
                                    asr_word_ids, taste_preds):
        """Per-word taste indices [B, Tw, L] onto asr tokens by word id ->
        embeddings [B, Ta, A], zero past each row's length.  Word ids past
        Tw (a full-budget asr buffer against a short decode) read the last
        row, where JAX's gather fills; both lie past the length."""
        ids = torch.clamp(asr_word_ids.long(), max=taste_preds.shape[1] - 1)
        gathered = _take_rows(taste_preds, ids)
        emb = codebook_output_from_indices(cb, gathered.clamp(min=0))
        mask = length_mask(asr_token_lengths, asr_word_ids.shape[1])
        return emb * mask[:, :, None]
