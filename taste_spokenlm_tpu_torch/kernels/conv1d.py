"""Same-padding dilated conv1d, channels-last, for the HiFT ResBlocks.

Replaces the TPU kernel ops/pallas/conv1d.py:45 `conv1d_same` (`_kernel`)
with csrc/conv1d.cu: a grid over (T tile, Cout tile, batch); each CTA stages
a halo'd x tile in shared memory per 32-channel slice and runs the K taps as
WMMA products (bf16 operands, f32 accumulate) on shifted views of it.  The
bias is added outside the kernel, after the cast to the activation dtype,
as in JAX.  Odd (K-1)*D is rejected (torch 'same' would be asymmetric).

Bound on the H100: at the vocoder's shapes (Cin = Cout = 256 at T = 7232,
128 at T = 57856, K in {3, 7, 11}) each output does K*Cin multiply-adds per
2*(Cin+Cout) bytes, so the tensor-core rate bounds it.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from taste_spokenlm_tpu_torch.kernels import _build

_SIGNATURE = {"tsk_conv1d_same": (
    _build.P, _build.P, _build.P, _build.I, _build.I, _build.I, _build.I,
    _build.I, _build.I, _build.P)}


def conv1d_same_plain(x: torch.Tensor, w: torch.Tensor,
                      b: Optional[torch.Tensor] = None, *,
                      dilation: int = 1) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch: a K-tap sum of shifted
    [T, Cin] @ [Cin, Cout] products in f32, cast to x's dtype, + bias."""
    k, _, _ = w.shape
    pad = (k - 1) * dilation
    if pad % 2:
        raise ValueError("conv1d_same: asymmetric same-padding not supported")
    t = x.shape[1]
    xp = F.pad(x.float(), (0, 0, pad // 2, pad // 2))
    acc = None
    for i in range(k):
        part = xp[:, i * dilation: i * dilation + t] @ w[i].float()
        acc = part if acc is None else acc + part
    y = acc.to(x.dtype)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def conv1d_same(x: torch.Tensor, w: torch.Tensor,
                b: Optional[torch.Tensor] = None, *,
                dilation: int = 1) -> torch.Tensor:
    """x [B, T, Cin], w [K, Cin, Cout] -> [B, T, Cout] (same padding).  CPU
    tensors take the plain version; CUDA tensors launch csrc/conv1d.cu
    (bf16 only)."""
    if x.device.type == "cpu":
        return conv1d_same_plain(x, w, b, dilation=dilation)
    if x.device.type != "cuda":
        raise ValueError(f"conv1d_same: unsupported device {x.device}")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"conv1d_same: the CUDA kernel takes bfloat16 "
                        f"(got {x.dtype}, {w.dtype})")
    if x.dim() != 3 or w.dim() != 3 or w.shape[1] != x.shape[2]:
        raise ValueError(f"conv1d_same: shapes {tuple(x.shape)}, "
                         f"{tuple(w.shape)}")
    bsz, t, cin = x.shape
    k, _, cout = w.shape
    halo = (k - 1) * dilation
    if halo % 2 or halo > 64 or cin % 32 or cout % 64:
        raise ValueError(f"conv1d_same: needs even (K-1)*D <= 64, Cin % 32 "
                         f"== 0 and Cout % 64 == 0 (K={k}, D={dilation}, "
                         f"Cin={cin}, Cout={cout})")
    if not (x.is_contiguous() and w.is_contiguous()) or w.device != x.device:
        raise ValueError("conv1d_same: x and w must be contiguous, on one device")
    lib = _build.load("conv1d", _SIGNATURE)
    y = torch.empty((bsz, t, cout), dtype=x.dtype, device=x.device)
    err = lib.tsk_conv1d_same(_build.ptr(x), _build.ptr(w), _build.ptr(y),
                              bsz, t, cin, cout, k, dilation,
                              _build.stream_of(x))
    _build.check(err, "conv1d_same")
    conv1d_same.launches += 1
    if b is not None:
        y = y + b.to(y.dtype)
    return y


conv1d_same.launches = 0
