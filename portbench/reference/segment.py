# Frozen copy of taste_spokenlm_tpu_torch/ops/segment.py at commit 1a9abc6: the plain path
# that the benchmark holds the port against.  Kernel, remat and
# data-parallel routes resolve to portbench/reference/stubs.py.
"""Ragged word-level ops as batched tensor ops (counterpart of the JAX
ops/segment.py: `segment_mean_pool`, `word_start_remap`, `remap_gather`,
`ragged_concat`, `compact_valid_rows`, `word_count`,
`cross_tokenizer_remap`, `alignment_mean_pool`)."""

from __future__ import annotations

import torch

from portbench.reference.masking import length_mask


def consecutive_group_ids(word_ids: torch.Tensor) -> torch.Tensor:
    """[B, T] word ids -> [B, T] 0-based consecutive-run ids."""
    change = (word_ids[:, 1:] != word_ids[:, :-1]).long()
    return torch.cat([torch.zeros_like(word_ids[:, :1], dtype=torch.long),
                      torch.cumsum(change, dim=1)], dim=1)


def segment_mean_pool(features: torch.Tensor, word_ids: torch.Tensor,
                      lengths: torch.Tensor) -> torch.Tensor:
    """Replace each valid position's feature by the mean of its
    consecutive-word-id run; positions past `lengths` are returned as is.
    features [B, T, C]; word_ids [B, T]; lengths [B] -> [B, T, C]."""
    b, t, c = features.shape
    groups = consecutive_group_ids(word_ids)
    valid = length_mask(lengths, t)
    oh = (groups[:, :, None] == torch.arange(t, device=features.device)
          [None, None, :]).to(features.dtype)
    oh = oh * valid[:, :, None].to(features.dtype)          # [B, T, G]
    counts = oh.sum(dim=1)                                  # [B, G]
    sums = torch.einsum("btg,btc->bgc", oh.float(), features.float())
    means = (sums / torch.clamp(counts.float(), min=1.0)[:, :, None]
             ).to(features.dtype)
    pooled = torch.einsum("btg,bgc->btc", oh.float(), means.float()
                          ).to(features.dtype)
    return torch.where(valid[:, :, None], pooled, features)


def word_start_mask(word_ids: torch.Tensor, lengths: torch.Tensor
                    ) -> torch.Tensor:
    """[B, T] -> bool [B, T]: True at the first token of each word run."""
    t = word_ids.shape[1]
    first = torch.cat([torch.ones_like(word_ids[:, :1], dtype=torch.bool),
                       word_ids[:, 1:] != word_ids[:, :-1]], dim=1)
    return first & length_mask(lengths, t)


def word_start_remap(src_word_ids, src_lengths, dst_word_ids, dst_lengths
                     ) -> torch.Tensor:
    """Word-start to word-start map M [B, Td, Ts] (1 at (first dst token of
    word w, first src token of word w), else 0)."""
    src_start = word_start_mask(src_word_ids, src_lengths)
    dst_start = word_start_mask(dst_word_ids, dst_lengths)
    same_word = dst_word_ids[:, :, None] == src_word_ids[:, None, :]
    m = same_word & dst_start[:, :, None] & src_start[:, None, :]
    return m.float()


def remap_gather(m: torch.Tensor, values: torch.Tensor, fill=-1
                 ) -> torch.Tensor:
    """Apply a {0,1} routing matrix m [B, Td, Ts] to integer payloads
    values [B, Ts, C] exactly: all-zero rows give `fill`."""
    src = torch.argmax(m, dim=-1)                           # [B, Td]
    has = m.sum(dim=-1) > 0
    gathered = torch.gather(
        values, 1, src[:, :, None].expand(-1, -1, values.shape[-1]))
    return torch.where(has[:, :, None], gathered,
                       torch.full_like(gathered, fill))


def ragged_concat(segments, out_len: int, pad_value=0.0):
    """Pack per-sample variable-length segments contiguously, left-aligned.

    segments: list of (tensor [B, Ti, C] or [B, Ti], lengths [B] or None).
    Returns (packed [B, out_len, ...], total_lengths [B])."""
    first = segments[0][0]
    b = first.shape[0]
    dev = first.device
    is_2d = first.dim() == 2
    bufs, lens, starts = [], [], []
    offset = 0
    for tensor, seg_len in segments:
        ti = tensor.shape[1]
        bufs.append(tensor[..., None] if is_2d else tensor)
        if seg_len is None:
            seg_len = torch.full((b,), ti, dtype=torch.long, device=dev)
        lens.append(seg_len.long())
        starts.append(offset)
        offset += ti
    buf = torch.cat(bufs, dim=1)                            # [B, sumTi, C]
    seg_lens = torch.stack(lens, dim=1)                     # [B, K]
    cum = torch.cat([torch.zeros((b, 1), dtype=torch.long, device=dev),
                     torch.cumsum(seg_lens, dim=1)], dim=1)
    total = cum[:, -1]
    pos = torch.arange(out_len, device=dev)[None, :]
    seg_id = (pos[:, :, None] >= cum[:, None, 1:]).sum(dim=-1)
    seg_id = torch.clamp(seg_id, max=len(segments) - 1)
    within = pos - torch.gather(cum, 1, seg_id)
    src = torch.tensor(starts, dtype=torch.long, device=dev)[seg_id] + within
    src = torch.clamp(src, 0, buf.shape[1] - 1)
    packed = torch.gather(buf, 1, src[:, :, None].expand(-1, -1, buf.shape[-1]))
    valid = pos < total[:, None]
    packed = torch.where(valid[:, :, None], packed,
                         torch.full_like(packed, pad_value))
    if is_2d:
        packed = packed[..., 0]
    return packed, total


def compact_valid_rows(values: torch.Tensor, valid: torch.Tensor,
                       out_len: int, pad_value=0) -> torch.Tensor:
    """Move the rows of values [B, T, ...] where valid [B, T] to the front,
    in order; [B, out_len, ...] with `pad_value` after them."""
    b, t = valid.shape
    dest = torch.cumsum(valid.long(), dim=1) - 1
    dest = torch.where(valid, dest, torch.full_like(dest, out_len))
    out = values.new_full((b, out_len + 1) + tuple(values.shape[2:]), pad_value)
    idx = dest.reshape(b, t, *([1] * (values.dim() - 2))).expand_as(values)
    out.scatter_(1, idx.clamp(max=out_len), values)
    return out[:, :out_len]


def word_count(word_ids: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """[B] number of word runs within each row's valid length."""
    return word_start_mask(word_ids, lengths).sum(dim=1)


def cross_tokenizer_remap(src_word_ids, src_lengths, dst_word_ids, dst_lengths
                          ) -> torch.Tensor:
    """Word-aligned remap matrix M [B, Td, Ts]: `M @ src_feats` copies, for
    every valid destination token, the feature of the first source token of
    the same word run (runs are matched by their order, as JAX does)."""
    ts = src_word_ids.shape[1]
    td = dst_word_ids.shape[1]
    dev = src_word_ids.device
    src_groups = consecutive_group_ids(src_word_ids)
    dst_groups = consecutive_group_ids(dst_word_ids)
    src_start = word_start_mask(src_word_ids, src_lengths)
    ar = torch.arange(ts, device=dev)
    src_sel = ((src_groups[:, None, :] == ar[None, :, None])
               & src_start[:, None, :])                      # [B, G, Ts]
    dst_sel = dst_groups[:, :, None] == ar[None, None, :]    # [B, Td, G]
    m = torch.einsum("btg,bgs->bts", dst_sel.float(), src_sel.float())
    return m * length_mask(dst_lengths, td)[:, :, None].float()


def alignment_mean_pool(feats: torch.Tensor, feat_lengths: torch.Tensor,
                        alignments: torch.Tensor, token_lengths: torch.Tensor
                        ) -> torch.Tensor:
    """The legacy segmenter's pooling: each token averages the frames i
    with start <= i <= end, where alignments [B, Ttok, 2] hold (start, end)
    in [0, 1] scaled by the row's feat length (truncated to int).  feats
    [B, Tf, C] -> [B, Ttok, C]; tokens past `token_lengths` and empty
    intervals give 0."""
    tf = feats.shape[1]
    bounds = (alignments.float() * feat_lengths.float()[:, None, None]
              ).to(torch.int32)
    frame = torch.arange(tf, device=feats.device)[None, None, :]
    sel = (frame >= bounds[:, :, 0:1]) & (frame <= bounds[:, :, 1:2])
    sel = sel & length_mask(token_lengths, alignments.shape[1])[:, :, None]
    w = sel.float()
    sums = torch.einsum("btf,bfc->btc", w, feats.float())
    counts = torch.clamp(w.sum(dim=-1, keepdim=True), min=1.0)
    return (sums / counts).to(feats.dtype)
