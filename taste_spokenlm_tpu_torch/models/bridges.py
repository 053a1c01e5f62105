"""LLM bridges: fuse text + taste into the Llama input, extract taste from
its output (counterpart of the JAX models/bridges.py).

Ported: the default pair (`weighted_sum` in, `continue_latent_linear_last`
out), `simple_sum` and `linear_last`.  At inference the continue-latent
head's latent is z = mu + sigma and its "logits" are scaled one-hots of
the nearest residual codebook indices; in train mode its forward value is
mu + sigma * eps, with the gradient of mu + sigma (JAX's reparameterised
straight-through), eps passed in or drawn from the caller's generator.
The other registry entries are in ROADMAP.md queue A, "What the earlier
slices left".
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from taste_spokenlm_tpu_torch.models.quantizer import (
    Codebook, codebook_indices_from_code)

_NOT_PORTED = ("bridge {!r} is not ported yet: ROADMAP.md queue A, "
               '"What the earlier slices left"')


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


class LinearLastExtract(nn.Module):
    """Per-level taste logits [B, T, L, K] from the last hidden state."""

    def __init__(self, hidden: int, k: int, l: int):
        super().__init__()
        self.k, self.l = k, l
        self.linear = nn.Linear(hidden, k * l)

    def forward(self, last_hidden, cb: Codebook = None, train: bool = False,
                eps=None, generator=None):
        b, t, _ = last_hidden.shape
        flat = F.linear(last_hidden.float(), self.linear.weight.float(),
                        self.linear.bias.float())
        return flat.reshape(b, t, self.l, self.k), {}


class ContinueLatentLinearLastExtract(nn.Module):
    """mu / logvar head over the last hidden state; z = mu + sigma; the
    nearest residual codebook indices as scaled one-hot logits."""

    def __init__(self, hidden: int, k: int, d: int):
        super().__init__()
        self.k = k
        self.fc_mu = nn.Linear(hidden, d)
        self.b_logvar = nn.Parameter(torch.zeros(d))

    def forward(self, last_hidden, cb: Codebook, train: bool = False,
                eps=None, generator=None):
        """`train` with `eps` [B, T, d] (or a `generator` to draw it from):
        z's value is mu + sigma * eps and its gradient that of mu + sigma;
        with neither, z = mu + sigma, as JAX's forward without a key.  The
        indices come from the detached z."""
        h = last_hidden.float()
        mu = F.linear(h, self.fc_mu.weight.float(), self.fc_mu.bias.float())
        logvar = self.b_logvar.float().expand_as(mu)
        sigma = torch.exp(0.5 * logvar)
        z = mu + sigma
        if train and (eps is not None or generator is not None):
            if eps is None:
                eps = torch.randn(mu.shape, generator=generator,
                                  device=mu.device)
            z = z + (mu + sigma * eps.to(mu.device) - z).detach()
        indices = codebook_indices_from_code(cb, z.detach())
        logits = F.one_hot(indices, self.k).float() * 1000.0
        return logits, {"z": z, "mu": mu, "logvar": logvar}


FUSION = {"weighted_sum": WeightedSumFusion, "simple_sum": SimpleSumFusion}


def make_fusion(name: str, llm_dim: int, audio_dim: int) -> nn.Module:
    if name not in FUSION:
        raise NotImplementedError(_NOT_PORTED.format(name))
    return FUSION[name](llm_dim, audio_dim)


def make_extract(name: str, hidden: int, k: int, d: int, l: int) -> nn.Module:
    if name == "linear_last":
        return LinearLastExtract(hidden, k, l)
    if name == "continue_latent_linear_last":
        return ContinueLatentLinearLastExtract(hidden, k, d)
    raise NotImplementedError(_NOT_PORTED.format(name))
