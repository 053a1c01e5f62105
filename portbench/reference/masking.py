# Frozen copy of taste_spokenlm_tpu_torch/ops/masking.py at commit 1a9abc6: the plain path
# that the benchmark holds the port against.  Kernel, remat and
# data-parallel routes resolve to portbench/reference/stubs.py.
"""Length / causal / chunk masks (counterpart of the JAX ops/masking.py).

Masks are boolean with True = attend/valid.
"""

from __future__ import annotations

import torch


def length_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """[B] -> [B, max_len] bool, True for valid positions."""
    pos = torch.arange(max_len, device=lengths.device)[None, :]
    return pos < lengths[:, None]


def causal_mask(t: int, device=None) -> torch.Tensor:
    """[t, t] lower-triangular (True = attend)."""
    return torch.ones((t, t), dtype=torch.bool, device=device).tril()


def chunk_causal_mask(t: int, chunk_size: int, device=None) -> torch.Tensor:
    """WeNet static-chunk mask: position i attends up to the end of its
    chunk.  chunk_size=1 is strict causal; chunk_size<=0 is full attention."""
    if chunk_size <= 0:
        return torch.ones((t, t), dtype=torch.bool, device=device)
    pos = torch.arange(t, device=device)
    chunk_end = (pos // chunk_size + 1) * chunk_size
    return pos[None, :] < chunk_end[:, None]


def combine_masks(*masks):
    """AND masks together, broadcasting; None entries skipped."""
    out = None
    for m in masks:
        if m is None:
            continue
        out = m if out is None else torch.logical_and(out, m)
    return out
