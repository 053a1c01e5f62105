"""LLM bridges: fuse text + taste into the Llama input, extract taste from
its output (counterpart of the JAX models/bridges.py, every entry of its
two registries).

In-bridges: `weighted_sum` (softmax([w_a, w_t]) over the projected audio
and the text), `simple_sum` and `reference_mix` (gated adapted-FFN blocks).
Out-bridges read the last hidden state, or a softmax-weighted sum of every
hidden state (`hidden_states`: the embeddings, each layer's output, the
final norm's output last), and emit per-level taste logits [B, T, L, K]:
linear heads, or scaled one-hots (x 1000) of the nearest residual codebook
indices of a predicted code.  The continue-latent heads' latent is
z = mu + sigma; in train mode its forward value is mu + sigma * eps, with
the gradient of mu + sigma (JAX's reparameterised straight-through), eps
passed in or drawn from the caller's generator.  `reference_mix` out reads
the taste embeds as its base and returns embeddings, not logits; JAX's
spoken LM cannot run it (it passes no base), and neither does the port's.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from taste_spokenlm_tpu_torch.models.quantizer import (
    Codebook, codebook_distributed_codes, codebook_indices_from_code)
from taste_spokenlm_tpu_torch.parallel import mesh


def _f32_linear(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x.float(), lin.weight.float(), lin.bias.float())


# ---------------------------------------------------------------------------
# in-bridges (fusion)
# ---------------------------------------------------------------------------


class WeightedSumFusion(nn.Module):
    """softmax([w_a, w_t]) weighted sum of the projected audio and the
    text embeds (f32 out; the backbone casts)."""

    def __init__(self, llm_dim: int, audio_dim: int,
                 weight_init_type: str = "zero_audio"):
        super().__init__()
        init = {"balance": [1.0, 1.0], "zero_audio": [-2.0, 2.0]}[weight_init_type]
        self.weights = nn.Parameter(torch.tensor(init))
        self.linear = nn.Linear(audio_dim, llm_dim)

    def forward(self, text_embeds, audio_embeds):
        w = torch.softmax(self.weights.float(), dim=0)
        audio = self.linear(audio_embeds.to(self.linear.weight.dtype))
        return w[0] * audio.float() + w[1] * text_embeds.float()


class SimpleSumFusion(nn.Module):
    """text + relu(alpha) * Linear(audio); alpha starts at 0."""

    def __init__(self, llm_dim: int, audio_dim: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.zeros(()))
        self.in_linear = nn.Linear(audio_dim, llm_dim)

    def forward(self, text_embeds, audio_embeds):
        audio = self.in_linear(audio_embeds.to(self.in_linear.weight.dtype))
        return text_embeds + F.relu(self.alpha) * audio


class AdaptedFFN(nn.Module):
    """Gated reference mixing block: sigmoid(MLP([based, ref])) gates a
    linear projection of `ref`, added onto `based` (a stack of linears, no
    activation between them, as JAX's)."""

    def __init__(self, based_dim: int, ref_dim: int, num_layers: int = 3):
        super().__init__()
        dims = [based_dim + ref_dim] + [based_dim] * num_layers
        self.mix_layers = nn.ModuleList(
            nn.Linear(dims[i], dims[i + 1]) for i in range(num_layers))
        self.value_linear = nn.Linear(ref_dim, based_dim)

    def forward(self, based_embeds, ref_embeds):
        dt = self.value_linear.weight.dtype
        hidden = torch.cat([based_embeds, ref_embeds], dim=-1).to(dt)
        for lin in self.mix_layers:
            hidden = lin(hidden)
        value = self.value_linear(ref_embeds.to(dt))
        return based_embeds + torch.sigmoid(hidden) * value


class ReferenceMixFusion(nn.Module):
    """`num_layers` adapted-FFN blocks mixing the audio into the text."""

    def __init__(self, llm_dim: int, audio_dim: int, num_layers: int = 3):
        super().__init__()
        self.layers = nn.ModuleList(AdaptedFFN(llm_dim, audio_dim)
                                    for _ in range(num_layers))

    def forward(self, text_embeds, audio_embeds):
        hidden = text_embeds
        for layer in self.layers:
            hidden = layer(hidden, audio_embeds)
        return hidden


BRIDGE_FUSION_CLASSES = {
    "weighted_sum": WeightedSumFusion,
    "reference_mix": ReferenceMixFusion,
    "simple_sum": SimpleSumFusion,
}


# ---------------------------------------------------------------------------
# out-bridges (extraction)
# ---------------------------------------------------------------------------


def _layer_weighted_sum(weights: torch.Tensor,
                        hidden_states: Sequence[torch.Tensor]) -> torch.Tensor:
    """softmax(weights) . stack(hidden_states), in f32."""
    w = torch.softmax(weights.float(), dim=0)
    stacked = torch.stack([h.float() for h in hidden_states], dim=0)
    return torch.einsum("l,lbtc->btc", w, stacked)


class _Extract(nn.Module):
    """The out-bridge call: (last_hidden [B, T, H], cb, train, eps,
    generator, hidden_states) -> (taste logits, info)."""

    needs_hidden_states = False


class LinearLastExtract(_Extract):
    """Per-level taste logits [B, T, L, K] from the last hidden state."""

    def __init__(self, hidden: int, k: int, l: int):
        super().__init__()
        self.k, self.l = k, l
        self.linear = nn.Linear(hidden, k * l)

    def forward(self, last_hidden, cb: Codebook = None, train: bool = False,
                eps=None, generator=None, hidden_states=None):
        b, t, _ = last_hidden.shape
        return _f32_linear(self.linear, last_hidden).reshape(
            b, t, self.l, self.k), {}


class WeightedLayerExtract(_Extract):
    """Per-level logits from the softmax-weighted sum of every hidden
    state (`num_layers` = the Llama's layers + 1)."""

    needs_hidden_states = True

    def __init__(self, hidden: int, k: int, l: int, num_layers: int):
        super().__init__()
        self.k, self.l = k, l
        self.weights = nn.Parameter(torch.ones(num_layers))
        self.linear = nn.Linear(hidden, k * l)

    def forward(self, last_hidden, cb: Codebook = None, train: bool = False,
                eps=None, generator=None, hidden_states=None):
        h = _layer_weighted_sum(self.weights, hidden_states)
        b, t, _ = h.shape
        return _f32_linear(self.linear, h).reshape(b, t, self.l, self.k), {}


class LinearAllConcatExtract(_Extract):
    """Per-level logits from the concatenation of every hidden state."""

    needs_hidden_states = True

    def __init__(self, hidden: int, k: int, l: int, num_layers: int):
        super().__init__()
        self.k, self.l = k, l
        self.linear = nn.Linear(hidden * num_layers, k * l)

    def forward(self, last_hidden, cb: Codebook = None, train: bool = False,
                eps=None, generator=None, hidden_states=None):
        h = torch.cat([x.float() for x in hidden_states], dim=-1)
        b, t, _ = h.shape
        return _f32_linear(self.linear, h).reshape(b, t, self.l, self.k), {}


class ReferenceMixExtract(_Extract):
    """Adapted-FFN blocks over the taste embeds (`audio_embeds`, the base)
    with the last hidden state as the reference; returns embeddings in the
    logits slot, as the reference does."""

    def __init__(self, hidden: int, audio_dim: int = 512, num_layers: int = 2):
        super().__init__()
        self.layers = nn.ModuleList(AdaptedFFN(audio_dim, hidden)
                                    for _ in range(num_layers))

    def forward(self, last_hidden, cb: Codebook = None, train: bool = False,
                eps=None, generator=None, hidden_states=None,
                audio_embeds=None):
        if audio_embeds is None:
            raise ValueError("reference_mix extraction needs audio_embeds "
                             "(the spoken LM, in JAX too, passes none)")
        hidden = audio_embeds
        for layer in self.layers:
            hidden = layer(hidden, last_hidden.to(hidden.dtype))
        return hidden, {}


class ContinueWeightedLayerExtract(_Extract):
    """Weighted-layer hidden -> linear d -> the nearest residual codebook
    indices as scaled one-hot logits (no latent)."""

    needs_hidden_states = True

    def __init__(self, hidden: int, k: int, d: int, num_layers: int):
        super().__init__()
        self.k = k
        self.weights = nn.Parameter(torch.ones(num_layers))
        self.linear = nn.Linear(hidden, d)

    def forward(self, last_hidden, cb: Codebook = None, train: bool = False,
                eps=None, generator=None, hidden_states=None):
        code = _f32_linear(self.linear, _layer_weighted_sum(self.weights,
                                                            hidden_states))
        indices = codebook_indices_from_code(cb, code.detach())
        return F.one_hot(indices, self.k).float() * 1000.0, {}


class ContinueLatentLinearLastExtract(_Extract):
    """mu / logvar head over the last hidden state (or, with `num_layers`,
    the weighted sum of every hidden state); z = mu + sigma; the nearest
    residual codebook indices as scaled one-hot logits."""

    def __init__(self, hidden: int, k: int, d: int,
                 num_layers: Optional[int] = None):
        super().__init__()
        self.k = k
        if num_layers is not None:
            self.weights = nn.Parameter(torch.ones(num_layers))
            self.needs_hidden_states = True
        self.fc_mu = nn.Linear(hidden, d)
        self.b_logvar = nn.Parameter(torch.zeros(d))

    def forward(self, last_hidden, cb: Codebook = None, train: bool = False,
                eps=None, generator=None, hidden_states=None):
        """`train` with `eps` [B, T, d] (or a `generator` to draw it from):
        z's value is mu + sigma * eps and its gradient that of mu + sigma;
        with neither, z = mu + sigma, as JAX's forward without a key.  The
        indices come from the detached z."""
        h = (_layer_weighted_sum(self.weights, hidden_states)
             if self.needs_hidden_states else last_hidden.float())
        mu = _f32_linear(self.fc_mu, h)
        logvar = self.b_logvar.float().expand_as(mu)
        sigma = torch.exp(0.5 * logvar)
        z = mu + sigma
        if train and (eps is not None or generator is not None):
            if eps is None:
                eps = mesh.draw_rows(lambda s: torch.randn(
                    s, generator=generator, device=mu.device), mu.shape)
            z = z + (mu + sigma * eps.to(mu.device) - z).detach()
        indices = codebook_indices_from_code(cb, z.detach())
        logits = F.one_hot(indices, self.k).float() * 1000.0
        return logits, {"z": z, "mu": mu, "logvar": logvar}


class ContinueLatentWeightedLayerExtract(ContinueLatentLinearLastExtract):
    """The continue-latent head over the weighted sum of every hidden
    state."""

    def __init__(self, hidden: int, k: int, d: int, num_layers: int):
        super().__init__(hidden, k, d, num_layers)


class MultiLinearLastExtract(_Extract):
    """Per-level logits from the last hidden state, and the soft codes
    (softmax over each level's logits against its codebook) summed over
    the levels, `agg_code` [B, T, Dc]."""

    def __init__(self, hidden: int, k: int, l: int):
        super().__init__()
        self.k, self.l = k, l
        self.linear = nn.Linear(hidden, k * l)

    def forward(self, last_hidden, cb: Codebook = None, train: bool = False,
                eps=None, generator=None, hidden_states=None):
        b, t, _ = last_hidden.shape
        logits = _f32_linear(self.linear, last_hidden).reshape(
            b, t, self.l, self.k)
        codes = codebook_distributed_codes(cb, logits)
        return logits, {"agg_code": codes.sum(dim=-2)}


BRIDGE_EXTRACT_CLASSES = {
    "linear_last": LinearLastExtract,
    "linear_all_concat": LinearAllConcatExtract,
    "reference_mix": ReferenceMixExtract,
    "weighted_layer": WeightedLayerExtract,
    "continue_weighted_layer": ContinueWeightedLayerExtract,
    "continue_latent_linear_last": ContinueLatentLinearLastExtract,
    "continue_latent_weighted_layer": ContinueLatentWeightedLayerExtract,
    "multi_linear_last": MultiLinearLastExtract,
}


def make_fusion(name: str, llm_dim: int, audio_dim: int) -> nn.Module:
    """The in-bridge `name` with JAX's defaults."""
    return BRIDGE_FUSION_CLASSES[name](llm_dim, audio_dim)


def make_extract(name: str, hidden: int, k: int, d: int, l: int,
                 num_layers: int = 1) -> nn.Module:
    """The out-bridge `name` as JAX's TasteSpokenLM builds it; `num_layers`
    is the Llama's layer count + 1 (the hidden states it returns)."""
    if name in ("linear_last", "multi_linear_last"):
        return BRIDGE_EXTRACT_CLASSES[name](hidden, k, l)
    if name in ("weighted_layer", "linear_all_concat"):
        return BRIDGE_EXTRACT_CLASSES[name](hidden, k, l, num_layers)
    if name == "continue_latent_linear_last":
        return ContinueLatentLinearLastExtract(hidden, k, d)
    if name in ("continue_weighted_layer", "continue_latent_weighted_layer"):
        return BRIDGE_EXTRACT_CLASSES[name](hidden, k, d, num_layers)
    if name == "reference_mix":
        return ReferenceMixExtract(hidden)
    raise KeyError(f"unknown out bridge {name!r}")
