"""Residual VQ (counterpart of the JAX models/quantizer.py `ResidualVQ`
forward, eval and train, `Codebook` and `codebook_*_from_indices`).

Buffers follow the vendored vector-quantize-pytorch state dict:
project_in / project_out Linears and layers.{i}._codebook.{embed, embed_avg,
cluster_size, initted} with the leading [1, ...] codebook-head dim.  The
train forward adds quantize dropout, gumbel code sampling, and the EMA
codebook update with dead-code expiry, written in place to those buffers
under no_grad (JAX threads them as the "quantizer" collection).  Its random
draws (the dropout level, the gumbel noise, the dead-code picks) are passed
in, or come from a torch.Generator.  Inside a data-parallel train step
(parallel/mesh.py `data_parallel`) the EMA counts and sums are summed over the ranks, the
dead-code picks are rows of the global batch and the commit loss divides by
the global count, as JAX's update over the global batch does under pjit.
`kmeans` and `ResidualVQ.init_codebook_state` initialise the codebooks.
The zoo of the reference (`QUANTIZER_CLASSES`): the plain VQ (a one-level
RVQ), the feature-grouped RVQ, the frozen k-means codebook and the linear
no-VQ bottleneck.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence

import torch
import torch.nn as nn

from taste_spokenlm_tpu_torch.config import QuantizerConfig
from taste_spokenlm_tpu_torch.parallel import mesh


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


def codebook_distributed_codes(cb: Codebook, logits: torch.Tensor
                               ) -> torch.Tensor:
    """Soft codes: per-level logits [..., Q, K] -> softmax-weighted
    codebook rows [..., Q, Dc] (no gradient to the codebooks)."""
    probs = torch.softmax(logits.float(), dim=-1)
    return torch.einsum("...qk,qkd->...qd", probs, cb.embed.detach().float())


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


def kmeans(samples: torch.Tensor, k: int, iters: int,
           generator: Optional[torch.Generator] = None,
           sample_weight: Optional[torch.Tensor] = None,
           init_idx: Optional[torch.Tensor] = None):
    """Plain Lloyd k-means on [N, D] samples -> (centroids [K, D], sizes
    [K]), as JAX's `kmeans` runs it.  The first centroids are the rows
    `init_idx` [K] when given, else K rows drawn from `generator` (distinct
    when N >= K, as jax.random.choice draws them)."""
    n = samples.shape[0]
    dev = samples.device
    if init_idx is None:
        init_idx = (torch.randperm(n, generator=generator, device=dev)[:k]
                    if n >= k else
                    torch.randint(0, n, (k,), generator=generator, device=dev))
    centroids = samples[init_idx.to(dev).long()]
    weight = (torch.ones(n, dtype=samples.dtype, device=dev)
              if sample_weight is None else sample_weight)
    sq = (samples ** 2).sum(dim=-1, keepdim=True)

    def assign(c):
        dists = sq - 2.0 * samples @ c.T + (c ** 2).sum(dim=-1)[None, :]
        return torch.argmin(dists, dim=-1)

    for _ in range(iters):
        onehot = (torch.nn.functional.one_hot(assign(centroids), k)
                  .to(samples.dtype) * weight[:, None])
        counts = onehot.sum(0)
        new = onehot.T @ samples / torch.clamp(counts, min=1e-9)[:, None]
        centroids = torch.where(counts[:, None] > 0, new, centroids)
    sizes = (torch.nn.functional.one_hot(assign(centroids), k)
             .to(samples.dtype).T @ weight)
    return centroids, sizes


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
        re-seeds dead codes from the rows `dead_picks` [Q, K] of the
        (global) batch; each draw comes from `generator` when not given."""
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
            u = mesh.draw_rows(lambda s: torch.rand(
                s, device=dev, generator=generator), (n_q, b * t, k), dim=1)
            gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
        embed = self.embeds().float()
        residual = z
        quantized = torch.zeros_like(z)
        indices, residuals, commit = [], [], z.new_zeros(())
        maskf = mask.float()[:, :, None]
        denom = torch.clamp(mesh.global_sum(maskf.sum()) * dc, min=1.0)
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
            counts = mesh.all_reduce_(onehot.sum(0))
            sums = mesh.all_reduce_(onehot.T @ res)
            size = cb.cluster_size[0].float() * decay + counts * (1 - decay)
            avg = cb.embed_avg[0].float() * decay + sums * (1 - decay)
            n = size.sum()
            smoothed = (size + eps) / (n + k * eps) * n
            emb = avg / torch.clamp(smoothed[:, None], min=1e-9)
            emb = torch.where(size[:, None] >= 1e-5, emb, cb.embed[0].float())
            if cfg.threshold_ema_dead_code > 0:
                if dead_picks is None:
                    valid_all = mesh.gather_rows(valid)
                    total = valid_all.sum()
                    probs = (valid_all / torch.clamp(total, min=1.0)
                             if total > 0 else
                             torch.full_like(valid_all,
                                             1.0 / valid_all.shape[0]))
                    pick = torch.multinomial(probs, k, replacement=True,
                                             generator=generator)
                else:
                    pick = dead_picks[qi].to(res.device).long()
                replacement = mesh.rows_at(res, pick)
                dead = size < cfg.threshold_ema_dead_code
                emb = torch.where(dead[:, None], replacement, emb)
                avg = torch.where(dead[:, None], replacement, avg)
                size = torch.where(dead, torch.ones_like(size), size)
            cb.embed[0].copy_(emb)
            cb.embed_avg[0].copy_(avg)
            cb.cluster_size[0].copy_(size)

    @torch.no_grad()
    def init_codebook_state(self, samples: torch.Tensor,
                            generator: Optional[torch.Generator] = None,
                            init_idx: Optional[torch.Tensor] = None) -> None:
        """K-means-initialise every level from samples [N, codebook_dim]
        (through project_in already, when the RVQ has one), as JAX's
        `init_codebook_state`: level q's codebook is the k-means of the
        residual the levels before it leave, embed_avg the codebook times
        the cluster sizes; without `kmeans_init`, normal draws x 0.02 and
        sizes 1.  Writes the four buffers.  `init_idx` [Q, K]: each level's
        first centroid rows (else drawn from `generator`).  Within
        mesh.data_parallel() the samples are every rank's, gathered."""
        cfg = self.config
        residual = mesh.gather_rows(samples).float()
        for qi, level in enumerate(self.layers):
            if cfg.kmeans_init:
                emb, size = kmeans(residual, cfg.codebook_size,
                                   cfg.kmeans_iters, generator,
                                   init_idx=(None if init_idx is None
                                             else init_idx[qi]))
            else:
                emb = torch.randn((cfg.codebook_size, cfg.codebook_dim),
                                  generator=generator,
                                  device=residual.device) * 0.02
                size = torch.ones(cfg.codebook_size, device=residual.device)
            residual = residual - emb[nearest(residual, emb)]
            cb = level._codebook
            cb.embed[0].copy_(emb)
            cb.embed_avg[0].copy_(emb * size[:, None])
            cb.cluster_size[0].copy_(size)
            cb.initted.fill_(1)

    # the index -> code APIs the grouped RVQ reads (JAX `ResidualVQ.get_*`)

    def get_codes_from_indices(self, indices: torch.Tensor) -> torch.Tensor:
        """[B, T, Q] -> per-level codes [Q, B, T, Dc]; -1 indices give 0."""
        return codebook_codes_from_indices(Codebook(self.embeds()), indices)

    def get_code_from_indices(self, indices: torch.Tensor) -> torch.Tensor:
        return self.get_codes_from_indices(indices).sum(dim=0)

    def get_output_from_indices(self, indices: torch.Tensor) -> torch.Tensor:
        """[B, T, Q] -> model-space vectors [B, T, dim]."""
        summed = self.get_code_from_indices(indices)
        return self.project_out(summed) if self.needs_projection else summed

    def codebook(self) -> Codebook:
        if self.needs_projection:
            return Codebook(self.embeds(), self.project_out.weight,
                            self.project_out.bias)
        return Codebook(self.embeds())


# ---------------------------------------------------------------------------
# the quantizer zoo (reference audio_quantizer.py)
# ---------------------------------------------------------------------------


class VectorQuantizer(nn.Module):
    """Plain single-level VQ: a ResidualVQ with one level and no quantize
    dropout, named `vq`."""

    def __init__(self, config: QuantizerConfig):
        super().__init__()
        self.config = config
        self.vq = ResidualVQ(config.replace(num_quantizers=1,
                                            quantize_dropout=False))

    def forward(self, x, mask=None, train: bool = False, generator=None,
                **draws):
        return self.vq(x, mask=mask, train=train, generator=generator,
                       **draws)


class GroupedResidualVQ(nn.Module):
    """Feature-grouped RVQ: x's last dim splits into `groups` chunks, each
    quantized by its own ResidualVQ (`rvqs.{g}`), outputs concatenated.
    Indices [B, T, G, Q]; the commit loss is the sum over the groups.

    In train mode each group draws its own quantize-dropout level (JAX
    folds the step key with the group), where the reference shares one
    level across the groups; the port follows JAX.  `draws` is one dict of
    the RVQ's draws a group (`drop_after`, `gumbel`, `dead_picks`)."""

    def __init__(self, config: QuantizerConfig):
        super().__init__()
        cfg = self.config = config
        if cfg.dim % cfg.groups:
            raise ValueError(f"dim {cfg.dim} not divisible by groups "
                             f"{cfg.groups}")
        sub = cfg.replace(dim=cfg.dim // cfg.groups, groups=1)
        self.rvqs = nn.ModuleList(ResidualVQ(sub) for _ in range(cfg.groups))

    def forward(self, x, mask=None, train: bool = False, generator=None,
                draws: Optional[Sequence[Dict]] = None):
        outs = [rvq(xg, mask=mask, train=train, generator=generator,
                    **(draws[g] if draws is not None else {}))
                for g, (rvq, xg) in enumerate(zip(
                    self.rvqs, x.chunk(self.config.groups, dim=-1)))]
        return {
            "quantized_feats": torch.cat(
                [o["quantized_feats"] for o in outs], dim=-1),
            "quantized_indices": torch.stack(
                [o["quantized_indices"] for o in outs], dim=2),
            "commit_loss": sum(o["commit_loss"] for o in outs)}

    def get_codes_from_indices(self, indices: torch.Tensor) -> torch.Tensor:
        """[B, T, G, Q] -> per-group per-level codes [G, Q, B, T, Dc]."""
        return torch.stack([rvq.get_codes_from_indices(indices[:, :, g])
                            for g, rvq in enumerate(self.rvqs)])

    def get_output_from_indices(self, indices: torch.Tensor) -> torch.Tensor:
        """[B, T, G, Q] -> model-space vectors [B, T, dim]."""
        return torch.cat([rvq.get_output_from_indices(indices[:, :, g])
                          for g, rvq in enumerate(self.rvqs)], dim=-1)


class KmeansQuantizer(nn.Module):
    """Nearest-neighbour lookup in a frozen external codebook (a buffer,
    loaded with the checkpoint)."""

    def __init__(self, codebook_size: int, dim: int):
        super().__init__()
        self.register_buffer("codebook", torch.zeros(codebook_size, dim))

    def forward(self, x, mask=None, train: bool = False, generator=None):
        b, t, d = x.shape
        cb = self.codebook.float()
        idx = nearest(x.reshape(-1, d).float(), cb).view(b, t)
        quant = cb[idx]
        if mask is not None:
            quant = quant * mask[:, :, None]
        return {"quantized_feats": quant.to(x.dtype),
                "quantized_indices": idx[..., None],
                "commit_loss": x.new_zeros((), dtype=torch.float32)}


class NoQuantizer(nn.Module):
    """Linear bottleneck (proj_in -> proj_out) without quantization; with a
    `codebook_size`, the bottleneck is snapped to a frozen k-means
    codebook's nearest row."""

    def __init__(self, dim: int, codebook_dim: int, codebook_size: int = 0):
        super().__init__()
        self.proj_in = nn.Linear(dim, codebook_dim)
        self.proj_out = nn.Linear(codebook_dim, dim)
        self.codebook_size = codebook_size
        if codebook_size:
            self.register_buffer("codebook",
                                 torch.zeros(codebook_size, codebook_dim))

    def forward(self, x, mask=None, train: bool = False, generator=None):
        z = self.proj_in(x)
        hidden = z
        result = {}
        if self.codebook_size:
            b, t, d = z.shape
            idx = nearest(z.reshape(-1, d).float(),
                          self.codebook.float()).view(b, t)
            z = self.codebook[idx].to(x.dtype)
            result["quantized_indices"] = idx[..., None]
        out = self.proj_out(z)
        if mask is not None:
            out = out * mask[:, :, None]
        result.update(quantized_feats=out,
                      commit_loss=x.new_zeros((), dtype=torch.float32),
                      intermediate_hiddens=hidden.detach())
        return result


QUANTIZER_CLASSES = {
    "rvq": ResidualVQ,
    "grouped_rvq": GroupedResidualVQ,
    "vq": VectorQuantizer,
    "kmeans": KmeansQuantizer,
    "no": NoQuantizer,
}
