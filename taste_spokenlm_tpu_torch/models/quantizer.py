"""Residual VQ, eval path (counterpart of the JAX models/quantizer.py
`ResidualVQ` forward, `Codebook` and `codebook_*_from_indices`).

Buffers follow the vendored vector-quantize-pytorch state dict:
project_in / project_out Linears and layers.{i}._codebook.{embed, embed_avg,
cluster_size, initted} with the leading [1, ...] codebook-head dim.
Training (EMA, k-means init, dead-code expiry, quantize dropout, gumbel
sampling) and the grouped / plain / k-means quantizers are not ported yet.
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


def nearest(residual: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """[N, D] x [K, D] -> [N] nearest code by euclidean distance:
    argmax(2 x.e - |e|^2), the same expression as JAX."""
    scores = 2.0 * residual @ codebook.T - (codebook ** 2).sum(dim=-1)[None, :]
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

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        """x [B, T, dim] -> quantized feats, indices [B, T, Q] and the
        summed per-level masked commit loss."""
        cfg = self.config
        z = self.project_in(x) if self.needs_projection else x
        z = z.float()
        b, t, dc = z.shape
        if mask is None:
            mask = torch.ones((b, t), dtype=torch.bool, device=z.device)
        embed = self.embeds().float()
        residual = z
        quantized = torch.zeros_like(z)
        indices, commit = [], z.new_zeros(())
        maskf = mask.float()[:, :, None]
        denom = torch.clamp(maskf.sum() * dc, min=1.0)
        for qi in range(cfg.num_quantizers):
            idx = nearest(residual.reshape(-1, dc), embed[qi]).view(b, t)
            quant = embed[qi][idx]
            commit = commit + ((quant - residual) ** 2 * maskf).sum() / denom
            quantized = quantized + quant
            residual = residual - quant
            indices.append(idx)
        # straight-through form of the JAX forward, z + (q - z): the same
        # float rounding as the reference
        quantized = (z + (quantized - z)).to(x.dtype)
        out = self.project_out(quantized) if self.needs_projection else quantized
        return {"quantized_feats": out,
                "quantized_indices": torch.stack(indices, dim=-1),
                "commit_loss": commit * cfg.commitment_weight}

    def codebook(self) -> Codebook:
        if self.needs_projection:
            return Codebook(self.embeds(), self.project_out.weight,
                            self.project_out.bias)
        return Codebook(self.embeds())
