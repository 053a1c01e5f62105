"""Residual VQ (counterpart of the JAX models/quantizer.py `ResidualVQ`
forward, eval and train, `Codebook` and `codebook_*_from_indices`).

Buffers follow the vendored vector-quantize-pytorch state dict:
project_in / project_out Linears and layers.{i}._codebook.{embed, embed_avg,
cluster_size, initted} with the leading [1, ...] codebook-head dim.  The
train forward adds quantize dropout, gumbel code sampling, and the EMA
codebook update with dead-code expiry, written in place to those buffers
under no_grad (JAX threads them as the "quantizer" collection).  Its random
draws (the dropout level, the gumbel noise, the dead-code picks) are passed
in, or come from a torch.Generator.  K-means codebook init and the grouped /
plain / k-means quantizers are not ported yet.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
import torch.nn as nn

from taste_spokenlm_tpu_torch.config import QuantizerConfig


class Codebook(NamedTuple):
    """RVQ codebooks + output projection as plain tensors."""

    embed: torch.Tensor                          # [Q, K, Dc]
    proj_weight: Optional[torch.Tensor] = None   # [dim, Dc] (torch Linear)
    proj_bias: Optional[torch.Tensor] = None     # [dim]


def codebook_codes_from_indices(cb: Codebook, indices: torch.Tensor
                                ) -> torch.Tensor:
    """[..., Q] -> per-level codes [Q, ..., Dc]; negative indices give 0."""
    out = []
    for qi in range(cb.embed.shape[0]):
        idx = indices[..., qi]
        c = cb.embed[qi][torch.clamp(idx, min=0)]
        out.append(torch.where((idx >= 0)[..., None], c, torch.zeros_like(c)))
    return torch.stack(out, dim=0)


def codebook_code_from_indices(cb: Codebook, indices: torch.Tensor
                               ) -> torch.Tensor:
    return codebook_codes_from_indices(cb, indices).sum(dim=0)


def codebook_output_from_indices(cb: Codebook, indices: torch.Tensor
                                 ) -> torch.Tensor:
    summed = codebook_code_from_indices(cb, indices)
    if cb.proj_weight is not None:
        summed = summed @ cb.proj_weight.T + cb.proj_bias
    return summed


def codebook_indices_from_code(cb: Codebook, code: torch.Tensor
                               ) -> torch.Tensor:
    """Codebook-space latents [..., Dc] -> nearest residual indices
    [..., Q]."""
    residual = code.float()
    dc = residual.shape[-1]
    indices = []
    for qi in range(cb.embed.shape[0]):
        emb = cb.embed[qi].float()
        idx = nearest(residual.reshape(-1, dc), emb).reshape(residual.shape[:-1])
        residual = residual - emb[idx]
        indices.append(idx)
    return torch.stack(indices, dim=-1)


def nearest(residual: torch.Tensor, codebook: torch.Tensor,
            gumbel: Optional[torch.Tensor] = None, temp: float = 0.0
            ) -> torch.Tensor:
    """[N, D] x [K, D] -> [N] nearest code by euclidean distance:
    argmax(2 x.e - |e|^2), the same expression as JAX; with `gumbel`
    [N, K] and temp > 0, gumbel-argmax sampling of scores / temp."""
    scores = 2.0 * residual @ codebook.T - (codebook ** 2).sum(dim=-1)[None, :]
    if gumbel is not None and temp > 0:
        scores = scores / temp + gumbel
    return torch.argmax(scores, dim=-1)


class _CodebookState(nn.Module):
    def __init__(self, size: int, dim: int):
        super().__init__()
        self.register_buffer("embed", torch.zeros(1, size, dim))
        self.register_buffer("embed_avg", torch.zeros(1, size, dim))
        self.register_buffer("cluster_size", torch.zeros(1, size))
        self.register_buffer("initted", torch.ones(1))


class _Level(nn.Module):
    def __init__(self, size: int, dim: int):
        super().__init__()
        self._codebook = _CodebookState(size, dim)


class ResidualVQ(nn.Module):
    """Residual VQ, eval forward; always runs in float32."""

    def __init__(self, config: QuantizerConfig):
        super().__init__()
        cfg = self.config = config
        if self.needs_projection:
            self.project_in = nn.Linear(cfg.dim, cfg.codebook_dim)
            self.project_out = nn.Linear(cfg.codebook_dim, cfg.dim)
        self.layers = nn.ModuleList(
            _Level(cfg.codebook_size, cfg.codebook_dim)
            for _ in range(cfg.num_quantizers))

    @property
    def needs_projection(self) -> bool:
        return self.config.codebook_dim != self.config.dim

    def embeds(self) -> torch.Tensor:
        """[Q, K, Dc] codebooks."""
        return torch.stack([lv._codebook.embed[0] for lv in self.layers])

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                train: bool = False,
                generator: Optional[torch.Generator] = None,
                drop_after=None, gumbel: Optional[torch.Tensor] = None,
                dead_picks: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        """x [B, T, dim] -> quantized feats (straight-through gradient to
        x), indices [B, T, Q] and the summed per-level masked commit loss.

        With `train`: quantize dropout keeps the levels <= `drop_after`
        (drawn in [cutoff, Q) when not given), gumbel sampling (when the
        config asks for it) adds `gumbel` [Q, B*T, K], and the EMA update
        re-seeds dead codes from the batch rows `dead_picks` [Q, K]; each
        draw comes from `generator` when not given."""
        cfg = self.config
        z = self.project_in(x) if self.needs_projection else x
        z = z.float()
        b, t, dc = z.shape
        n_q, k = cfg.num_quantizers, cfg.codebook_size
        dev = z.device
        if mask is None:
            mask = torch.ones((b, t), dtype=torch.bool, device=dev)
        if not (train and cfg.quantize_dropout):
            drop_after = None
        elif drop_after is None:
            drop_after = int(torch.randint(
                cfg.quantize_dropout_cutoff_index, n_q, (), device=dev,
                generator=generator))
        sample = train and cfg.stochastic_sample_codes \
            and cfg.sample_codebook_temp > 0
        if sample and gumbel is None:
            u = torch.rand((n_q, b * t, k), device=dev, generator=generator)
            gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
        embed = self.embeds().float()
        residual = z
        quantized = torch.zeros_like(z)
        indices, residuals, commit = [], [], z.new_zeros(())
        maskf = mask.float()[:, :, None]
        denom = torch.clamp(maskf.sum() * dc, min=1.0)
        for qi in range(n_q):
            residuals.append(residual)
            idx = nearest(residual.reshape(-1, dc), embed[qi],
                          gumbel[qi] if sample else None,
                          cfg.sample_codebook_temp).view(b, t)
            quant = embed[qi][idx]
            if drop_after is not None and qi > drop_after:
                idx = torch.full_like(idx, -1)
                quant = torch.zeros_like(quant)
            else:
                # the commit term of a live level (stop-gradient on quant)
                commit = commit + ((quant - residual) ** 2 * maskf).sum() / denom
            quantized = quantized + quant
            residual = residual - quant
            indices.append(idx)
        indices = torch.stack(indices, dim=-1)
        # straight-through form of the JAX forward, z + (q - z): the same
        # float rounding as the reference; the gradient flows to z alone
        quantized = (z + (quantized - z).detach()).to(x.dtype)
        if train:
            self._ema_update(indices, mask, residuals, generator, dead_picks)
        out = self.project_out(quantized) if self.needs_projection else quantized
        return {"quantized_feats": out, "quantized_indices": indices,
                "commit_loss": commit * cfg.commitment_weight}

    @torch.no_grad()
    def _ema_update(self, indices, mask, residuals, generator, dead_picks):
        """The EMA codebook update of JAX `_ema_update`, in place: per level,
        counts and sums of the forward's actual residual inputs over the
        valid (masked-in, not dropped) rows, smoothed cluster sizes, and
        dead codes (EMA size below the threshold) re-seeded from the batch
        rows `dead_picks[qi]` (drawn with probability over the valid rows,
        uniform when there are none)."""
        cfg = self.config
        decay, eps, k = cfg.decay, cfg.epsilon, cfg.codebook_size
        maskf = mask.float().reshape(-1)
        for qi, level in enumerate(self.layers):
            cb = level._codebook
            idx = indices[..., qi].reshape(-1)
            res = residuals[qi].detach().reshape(idx.shape[0], -1)
            valid = maskf * (idx >= 0).float()
            onehot = torch.nn.functional.one_hot(
                idx.clamp(min=0), k).float() * valid[:, None]
            counts = onehot.sum(0)
            sums = onehot.T @ res
            size = cb.cluster_size[0].float() * decay + counts * (1 - decay)
            avg = cb.embed_avg[0].float() * decay + sums * (1 - decay)
            n = size.sum()
            smoothed = (size + eps) / (n + k * eps) * n
            emb = avg / torch.clamp(smoothed[:, None], min=1e-9)
            emb = torch.where(size[:, None] >= 1e-5, emb, cb.embed[0].float())
            if cfg.threshold_ema_dead_code > 0:
                if dead_picks is None:
                    total = valid.sum()
                    probs = (valid / torch.clamp(total, min=1.0) if total > 0
                             else torch.full_like(valid, 1.0 / valid.shape[0]))
                    pick = torch.multinomial(probs, k, replacement=True,
                                             generator=generator)
                else:
                    pick = dead_picks[qi].to(res.device).long()
                replacement = res[pick]
                dead = size < cfg.threshold_ema_dead_code
                emb = torch.where(dead[:, None], replacement, emb)
                avg = torch.where(dead[:, None], replacement, avg)
                size = torch.where(dead, torch.ones_like(size), size)
            cb.embed[0].copy_(emb)
            cb.embed_avg[0].copy_(avg)
            cb.cluster_size[0].copy_(size)

    def codebook(self) -> Codebook:
        if self.needs_projection:
            return Codebook(self.embeds(), self.project_out.weight,
                            self.project_out.bias)
        return Codebook(self.embeds())
