"""What the frozen copies import from the port's kernels, remat, device and
data-parallel modules, reduced to the plain single-process path: every
kernel gate says no, a layer runs without recomputation, and a sum or a
draw over ranks is the process's own."""

from __future__ import annotations

import torch
import torch.nn as nn


def _no_kernel(*args, **kwargs):
    raise RuntimeError("the reference runs no kernel")


flash_attention = flash_attention_plain = _no_kernel
relpos_causal_attention = fused_ffn_apply = _no_kernel
fused_dit_block = fused_dit_block_plain = _no_kernel
conv1d_same = conv1d_same_plain = _no_kernel


def can_use_flash(*args, **kwargs) -> bool:
    return False


can_use_relpos_flash = can_use_fused_dit = can_use_flash


def qmode(flag):
    if flag:
        raise ValueError("the reference holds float weights only")
    return None


def dense(in_dim: int, features: int, quantized=False, use_bias: bool = True):
    qmode(quantized)
    return nn.Linear(in_dim, features, bias=use_bias)


def call_layer(layer, remat, *args, **kwargs):
    return layer(*args, **kwargs)


def resolve_device(device=None) -> torch.device:
    return torch.device("cpu" if device is None else device)


# one process: a batch's sums and draws are its own


def span() -> int:
    return 1


def draw_rows(draw, shape, dim: int = 0):
    return draw(tuple(shape))


def all_reduce_(x):
    return x


def global_sum(x):
    return x


def gather_rows(x):
    return x


def rows_at(x, idx):
    return x[idx]


def global_std(x):
    return x.std(unbiased=False)
