"""TASLM, the earlier stage-2 spoken LM (counterpart of the JAX
models/taslm.py).

A Llama backbone with a parallel speech channel: each step's speech token
(C RVQ channels of a vocab of V, bos V and eos V + 1; or one channel over
V + 2 ids) is embedded through the RVQ codebooks (a `Codebook`, passed in
as in JAX) and projected to the Llama width, or by a plain embedding in
the single-channel case, then fused with the text embedding (addition,
gated or weighted sum).  The hidden state predicts the next text token and
the next speech token(s): a multi-channel CE head with a per-channel decay,
or a MELLE-style latent sampling layer trained with L_reg + 2 L_kl.  The
loss is 0.5 text + 0.5 speech; optionally with the text KL to the
adapter-disabled base.

`generate` is the KV-cached joint decode of JAX's `while_loop` as a Python
loop over the port's Llama cache: the modes continue (speech length ==
text length), conditional (the surplus speech ids are forced) and TTS
(text forced from the prompt).  It stops on channel 0's speech eos, on
more than `speech_repetition_max` repeats of one channel-0 id, or at
`max_steps`; after the terminate id the text is forced to it.  Its draws
are Gumbel noise, read from `text_gumbel` [max_steps, V] /
`speech_gumbel` [max_steps, C, H] when given (JAX's categorical is the
argmax of the logits plus such noise) or drawn from `generator`.

State-dict names: language_model.* (the port's Llama names),
fusion_layer.{layer_norm_speech, gate, weights}, speech_embed_tokens,
speech_special_embed (the learned bos / eos rows of the multi-channel
embedding), speech_token_embed_proj_layer, speech_rvq_hidden_proj_layer,
speech_head, speech_latent_sampler.{fc_mu, b_logvar}.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from taste_spokenlm_tpu_torch.config import LlamaConfig, LoraConfig, _Base
from taste_spokenlm_tpu_torch.device import resolve_device
from taste_spokenlm_tpu_torch.models.llama import LlamaModel
from taste_spokenlm_tpu_torch.models.quantizer import (
    Codebook, codebook_output_from_indices)
from taste_spokenlm_tpu_torch.ops.losses import (IGNORE_ID, kl_to_reference,
                                                 masked_log_likelihood)
from taste_spokenlm_tpu_torch.ops.sampling import gumbel_noise, mask_top_p


@dataclass(frozen=True)
class TaslmConfig(_Base):
    llama: LlamaConfig = field(default_factory=LlamaConfig)
    lora: Optional[LoraConfig] = field(default_factory=LoraConfig)
    use_lora: bool = True
    speech_vocab_size: int = 4096
    speech_num_channels: int = 4
    speech_bos_id: int = 4096
    speech_eos_id: int = 4097
    speech_hidden_size: int = 1280          # RVQ model-space width
    fusion_method: str = "addition"         # addition | gated | weighted_sum
    fusion_normalize_speech: bool = False
    speech_multi_channel_loss_decay_factor: float = 1.0
    speech_token_adopt_latent_sampling: bool = False
    latent_dim: int = 256
    text_conduct_kl_loss: bool = False
    text_kl_vocab_cutoff: int = 80000       # KL over the plain-text vocab slice
    # project the hidden back to the RVQ model space and regress the next
    # step's encoded speech input (an auxiliary loss)
    speech_labels_apply_quantization: bool = False

    @classmethod
    def tiny(cls) -> "TaslmConfig":
        return cls(llama=LlamaConfig.tiny(), lora=LoraConfig.tiny(),
                   speech_vocab_size=32, speech_num_channels=4,
                   speech_bos_id=32, speech_eos_id=33, speech_hidden_size=64,
                   latent_dim=16, text_kl_vocab_cutoff=256)


class TaslmFusion(nn.Module):
    """addition / gated / weighted_sum of the text and speech embeddings,
    in f32 (JAX's float32 parameters promote the sum)."""

    def __init__(self, method: str, hidden_size: int,
                 normalize_speech: bool = False):
        super().__init__()
        if method not in ("addition", "gated", "weighted_sum"):
            raise ValueError(f"fusion_method {method!r}")
        self.method = method
        if normalize_speech:
            self.layer_norm_speech = nn.LayerNorm(hidden_size, eps=1e-5)
        if method == "gated":
            self.gate = nn.Linear(2 * hidden_size, 2, bias=False)
        if method == "weighted_sum":
            self.weights = nn.Parameter(torch.tensor([-2.0, 2.0]))

    def forward(self, text_embeds, speech_embeds):
        text, speech = text_embeds.float(), speech_embeds.float()
        if hasattr(self, "layer_norm_speech"):
            ln = self.layer_norm_speech
            speech = F.layer_norm(speech, ln.normalized_shape,
                                  ln.weight.float(), ln.bias.float(), ln.eps)
        if self.method == "addition":
            return text + speech
        if self.method == "gated":
            gate = torch.sigmoid(F.linear(torch.cat([text, speech], dim=-1),
                                          self.gate.weight.float()))
            return gate[..., 0:1] * text + gate[..., 1:2] * speech
        w = torch.softmax(self.weights.float(), dim=0)
        return w[0] * speech + w[1] * text


class LatentSamplingLayer(nn.Module):
    """mu / logvar head and its latent: z = mu + sigma, in train mode with
    the value mu + sigma * eps and the gradient of mu + sigma."""

    def __init__(self, hidden_size: int, latent_dim: int):
        super().__init__()
        self.fc_mu = nn.Linear(hidden_size, latent_dim)
        self.b_logvar = nn.Parameter(torch.zeros(latent_dim))

    def forward(self, hidden, train: bool = False, eps=None, generator=None):
        mu = F.linear(hidden.float(), self.fc_mu.weight.float(),
                      self.fc_mu.bias.float())
        logvar = self.b_logvar.float().expand_as(mu)
        sigma = torch.exp(0.5 * logvar)
        z = mu + sigma
        if train and (eps is not None or generator is not None):
            if eps is None:
                eps = torch.randn(mu.shape, generator=generator,
                                  device=mu.device)
            z = z + (mu + sigma * eps.to(mu.device) - z).detach()
        return mu, logvar, z


def _masked_mean_sq(pred, tgt, valid):
    denom = torch.clamp(valid.sum() * tgt.shape[-1], min=1.0)
    return ((pred - tgt) ** 2 * valid).sum() / denom


class TaslmForCausalLM(nn.Module):
    """Built on `device` (CUDA unless the caller passes "cpu"; without
    CUDA it raises), as the port's other entry points."""

    def __init__(self, config: TaslmConfig,
                 dtype: torch.dtype = torch.float32,
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__()
        cfg = self.config = config
        self.dtype = dtype
        self.device = resolve_device(device)
        h, c = cfg.llama.hidden_size, cfg.speech_num_channels
        self.language_model = LlamaModel(
            cfg.llama, cfg.lora if cfg.use_lora else None, dtype)
        self.fusion_layer = TaslmFusion(cfg.fusion_method, h,
                                        cfg.fusion_normalize_speech)
        if c > 1:
            self.speech_special_embed = nn.Embedding(4, cfg.speech_hidden_size)
            self.speech_token_embed_proj_layer = nn.Linear(
                cfg.speech_hidden_size, h)
            if cfg.speech_labels_apply_quantization:
                self.speech_rvq_hidden_proj_layer = nn.Linear(
                    h, cfg.speech_hidden_size)
        else:
            self.speech_embed_tokens = nn.Embedding(cfg.speech_vocab_size + 2, h)
        if cfg.speech_token_adopt_latent_sampling:
            self.speech_latent_sampler = LatentSamplingLayer(h, cfg.latent_dim)
        else:
            # single-channel: the head covers bos / eos, so the decode can
            # emit the speech eos
            self.speech_head_size = (cfg.speech_vocab_size + 2 if c == 1
                                     else cfg.speech_vocab_size)
            self.speech_head = nn.Linear(h, c * self.speech_head_size,
                                         bias=False)
        for name, mod in self.named_children():
            if name not in ("language_model", "fusion_layer",
                            "speech_latent_sampler"):
                mod.to(dtype)
        self.to(self.device)

    def _encode_speech_rvq(self, cb: Codebook, speech_ids: torch.Tensor
                           ) -> torch.Tensor:
        """[B, T, C] ids -> RVQ model-space embeds [B, T, A]; bos / eos
        (>= vocab on channel 0) take the learned special rows."""
        v = self.config.speech_vocab_size
        ids = speech_ids.long()
        is_special = ids[..., 0] >= v
        rvq = codebook_output_from_indices(cb, ids.clamp(0, v - 1))
        special = self.speech_special_embed((ids[..., 0] - v).clamp(0, 3))
        return torch.where(is_special[..., None], special,
                           rvq.to(special.dtype))

    def embed_speech(self, cb: Optional[Codebook], speech_ids: torch.Tensor
                     ) -> torch.Tensor:
        """[B, T, C] ids (or [B, T] single-channel) -> Llama-width embeds."""
        if self.config.speech_num_channels == 1:
            return self.speech_embed_tokens(speech_ids.long())
        return self.speech_token_embed_proj_layer(
            self._encode_speech_rvq(cb, speech_ids))

    def _embed_text(self, ids: torch.Tensor) -> torch.Tensor:
        return self.language_model.embed_tokens(ids.long()).to(self.dtype)

    def forward(self, cb: Optional[Codebook], text_input_ids,
                speech_input_ids, text_labels=None, speech_labels=None,
                attention_lengths=None, train: bool = False, eps=None,
                generator: Optional[torch.Generator] = None,
                ref_logits=None, compute_ref_kl: bool = False
                ) -> Dict[str, torch.Tensor]:
        """The teacher-forced forward: text_logits, speech_logits (or the
        latent's speech_y_pred / mu / logvar) and, given labels, the
        losses (text_ce_loss, text_kl_loss, speech_layer_{c}_ce_loss,
        speech_recon_loss, speech_latent_{reg,kl}_loss, loss).  `train`
        with `eps` or `generator` samples the latent.  `compute_ref_kl`
        (with text_conduct_kl_loss) runs the base, adapters off, over the
        text embeddings alone as the KL's teacher."""
        cfg = self.config
        lm = self.language_model
        text_embeds = self._embed_text(text_input_ids)
        speech_embeds = self.embed_speech(cb, speech_input_ids)
        combined = self.fusion_layer(text_embeds, speech_embeds)
        hidden = lm(inputs_embeds=combined,
                    attention_lengths=attention_lengths)["last_hidden"]
        text_logits = lm.logits(hidden)
        if cfg.text_conduct_kl_loss and compute_ref_kl and ref_logits is None:
            with torch.no_grad():
                ref_logits = lm.logits(lm(
                    inputs_embeds=text_embeds,
                    attention_lengths=attention_lengths,
                    disable_lora=True)["last_hidden"])
        result: Dict[str, torch.Tensor] = {"text_logits": text_logits}
        total_text, total_speech = 0.0, 0.0

        if text_labels is not None:
            tl = text_labels[:, 1:].long()
            logp = torch.log_softmax(text_logits[:, :-1].float(), dim=-1)
            valid = tl != IGNORE_ID
            nll = -torch.gather(logp, -1, tl.clamp(min=0)[..., None])[..., 0]
            total_text = (torch.where(valid, nll, torch.zeros_like(nll)).sum()
                          / torch.clamp(valid.sum(), min=1))
            result["text_ce_loss"] = total_text
            if cfg.text_conduct_kl_loss and ref_logits is not None:
                cut = cfg.text_kl_vocab_cutoff
                # JAX masks the KL with ~valid (the ignored positions)
                kl = kl_to_reference(text_logits[:, :-1, :cut],
                                     ref_logits[:, :-1, :cut], ~valid)
                total_text = total_text + kl
                result["text_kl_loss"] = kl

        if cfg.speech_token_adopt_latent_sampling:
            mu, logvar, z = self.speech_latent_sampler(hidden, train, eps,
                                                       generator)
            result.update(speech_y_pred=z, speech_mu=mu, speech_logvar=logvar)
            if speech_labels is not None:
                target = codebook_output_from_indices(
                    cb, speech_labels.long().clamp(0, cfg.speech_vocab_size - 1)
                ).float()
                tgt, valid = target[:, 1:], (
                    speech_labels[:, 1:, 0] != IGNORE_ID)[..., None].float()
                l_reg = _masked_mean_sq(z[:, :-1], tgt, valid)
                mu_s, lv_s = mu[:, :-1], logvar[:, :-1]
                l_kl = 0.5 * ((torch.exp(lv_s) + (mu_s - tgt) ** 2 - 1 - lv_s)
                              .mean(dim=-1, keepdim=True) * valid).sum() \
                    / torch.clamp(valid.sum(), min=1.0)
                total_speech = l_reg + 2.0 * l_kl
                result["speech_latent_reg_loss"] = l_reg
                result["speech_latent_kl_loss"] = l_kl
        else:
            b, t = text_input_ids.shape
            hs = self.speech_head_size
            sp_logits = self.speech_head(hidden).reshape(
                b, t, cfg.speech_num_channels, hs)
            result["speech_logits"] = sp_logits
            if speech_labels is not None:
                decay = cfg.speech_multi_channel_loss_decay_factor
                for c in range(cfg.speech_num_channels):
                    sl = speech_labels[:, 1:, c].long()
                    logp = torch.log_softmax(sp_logits[:, :-1, c].float(),
                                             dim=-1)
                    valid = (sl != IGNORE_ID) & (sl < hs)
                    nll = -torch.gather(logp, -1,
                                        sl.clamp(0, hs - 1)[..., None])[..., 0]
                    ce = (torch.where(valid, nll, torch.zeros_like(nll)).sum()
                          / torch.clamp(valid.sum(), min=1))
                    total_speech = total_speech + decay ** (c + 1) * ce
                    result[f"speech_layer_{c}_ce_loss"] = ce
                if (cfg.speech_num_channels > 1
                        and cfg.speech_labels_apply_quantization):
                    enc_in = self._encode_speech_rvq(cb, speech_input_ids)
                    recon = self.speech_rvq_hidden_proj_layer(hidden)
                    valid = (speech_labels[:, 1:, 0] != IGNORE_ID
                             )[..., None].float()
                    recon_loss = _masked_mean_sq(recon[:, :-1].float(),
                                                 enc_in[:, 1:].float(), valid)
                    total_speech = total_speech + decay * recon_loss
                    result["speech_recon_loss"] = recon_loss
        result["loss"] = 0.5 * total_text + 0.5 * total_speech
        return result

    def calculate_log_likelihood(self, cb: Optional[Codebook],
                                 text_input_ids, speech_input_ids,
                                 text_labels, speech_labels,
                                 attention_lengths=None
                                 ) -> Dict[str, torch.Tensor]:
        """The reference's selection protocol: one teacher-forced forward,
        then the mean text log-likelihood and each channel's speech
        log-likelihood over the valid shifted labels, each with its
        reversed-labels control."""
        cfg = self.config
        out = self(cb, text_input_ids, speech_input_ids,
                   attention_lengths=attention_lengths)
        res: Dict[str, torch.Tensor] = {}
        ll, rll = masked_log_likelihood(out["text_logits"][:, :-1],
                                        text_labels[:, 1:])
        res["text_log_likelihood"] = ll
        res["reversed_text_log_likelihood"] = rll
        if not cfg.speech_token_adopt_latent_sampling:
            sp = out["speech_logits"]
            for c in range(cfg.speech_num_channels):
                sl = (speech_labels[:, 1:, c] if speech_labels.dim() == 3
                      else speech_labels[:, 1:])
                ll, rll = masked_log_likelihood(
                    sp[:, :-1, c], sl, head_size=self.speech_head_size)
                res[f"speech_log_likelihood.{c}"] = ll
                res[f"reversed_speech_log_likelihood.{c}"] = rll
        return res

    @torch.no_grad()
    def generate(self, cb: Optional[Codebook], text_input_ids,
                 speech_input_ids, text_length: int, speech_length: int,
                 max_steps: int = 64, text_top_p: float = 0.9,
                 speech_top_p: float = 0.3, temperature: float = 1.0,
                 speech_use_greedy: bool = False, is_tts: bool = False,
                 speech_repetition_max: int = 5,
                 text_terminate_id: Optional[int] = None,
                 generator: Optional[torch.Generator] = None,
                 text_gumbel: Optional[torch.Tensor] = None,
                 speech_gumbel: Optional[torch.Tensor] = None
                 ) -> Dict[str, torch.Tensor]:
        """The joint (text, speech) decode of one row: text_input_ids
        [1, Tt], speech_input_ids [1, Ts, C] (or [1, Ts]) ->
        text_ids [max_steps], speech_ids [max_steps(, C)] (IGNORE_ID past
        the last step) and num_steps."""
        cfg = self.config
        lm = self.language_model
        dev = text_input_ids.device
        multi = speech_input_ids.dim() == 3
        c = speech_input_ids.shape[-1] if multi else 1
        terminate_id = (text_terminate_id if text_terminate_id is not None
                        else cfg.llama.eos_token_id)
        tt, ts = text_input_ids.shape[1], speech_input_ids.shape[1]
        cond_len = 1 if is_tts else int(text_length)
        n_forced = max(int(speech_length) - cond_len, 0)

        sp_prefix = (speech_input_ids[:, :tt] if ts >= tt else F.pad(
            speech_input_ids, ((0, 0) if multi else ()) + (0, tt - ts)))
        fused = self.fusion_layer(self._embed_text(text_input_ids),
                                  self.embed_speech(cb, sp_prefix))
        total = tt + max_steps
        caches = lm.init_cache(1, total)
        slot = torch.arange(total, device=dev)
        out0 = lm(inputs_embeds=fused, caches=caches, cache_index=0,
                  key_valid=(slot < cond_len)[None])
        hidden = out0["last_hidden"][0, cond_len - 1]

        out_text = torch.full((max_steps,), IGNORE_ID, dtype=torch.long,
                              device=dev)
        out_speech = torch.full((max_steps, c) if multi else (max_steps,),
                                IGNORE_ID, dtype=torch.long, device=dev)
        text_ids_host = text_input_ids[0].tolist()
        forced_sp_host = speech_input_ids[0].tolist()
        forced_text_id, rep_tok, rep_cnt, step = -1, -1, 0, 0
        v = cfg.llama.vocab_size
        hs = self.speech_head_size
        while step < max_steps:
            text_logits = lm.logits(hidden[None, None])[0, 0].float()
            if is_tts:
                text_id = int(text_ids_host[min(step + 1, tt - 1)])
            else:
                g = (text_gumbel[step].to(dev) if text_gumbel is not None
                     else gumbel_noise((v,), generator, dev))
                filt = mask_top_p(text_logits / temperature, text_top_p)
                text_id = int(torch.argmax(filt + g))
            if forced_text_id >= 0:
                text_id = forced_text_id
            elif text_id == terminate_id:
                forced_text_id = terminate_id
            head = self.speech_head(hidden[None, None]).reshape(
                cfg.speech_num_channels, hs).float()
            if step < n_forced:
                row = forced_sp_host[min(cond_len + step, ts - 1)]
                sp_ids = torch.tensor((row if multi else [row])[:c],
                                      dtype=torch.long, device=dev)
            elif speech_use_greedy:
                sp_ids = torch.argmax(head, dim=-1)
            else:
                g = (speech_gumbel[step].to(dev) if speech_gumbel is not None
                     else gumbel_noise(tuple(head.shape), generator, dev))
                sp_ids = torch.argmax(
                    mask_top_p(head / temperature, speech_top_p) + g, dim=-1)
            sp0 = int(sp_ids[0])
            rep_cnt = rep_cnt + 1 if sp0 == rep_tok else 0
            rep_tok = sp0
            out_text[step] = text_id
            out_speech[step] = sp_ids if multi else sp0
            step += 1
            if (sp0 == cfg.speech_eos_id or rep_cnt > speech_repetition_max
                    or step == max_steps):
                break
            pos = cond_len + step - 1
            sp_in = sp_ids[None, None] if multi else sp_ids[:1][None]
            fused = self.fusion_layer(
                self._embed_text(torch.tensor([[text_id]], device=dev)),
                self.embed_speech(cb, sp_in))
            hidden = lm(inputs_embeds=fused, caches=caches, cache_index=pos,
                        position_offset=pos,
                        key_valid=(slot < pos + 1)[None])["last_hidden"][0, 0]
        return {"text_ids": out_text, "speech_ids": out_speech,
                "num_steps": step}
