"""Same-padding dilated conv1d, channels-last, for the HiFT ResBlocks.

Replaces the TPU kernel ops/pallas/conv1d.py:45 `conv1d_same` (`_kernel`)
with csrc/conv1d.cu: a grid over (T tile, Cout tile, batch); each CTA stages
the halo'd x rows of a 32-channel chunk once and runs the K taps as
tensor-core products (mma.sync, bf16 operands, f32 sums) on row-shifted
reads of it, the weight tiles streaming through a cp.async ring.  The sum
is cast to x's dtype once, and the bias is added to that in the kernel's
epilogue, in bf16 as JAX adds it outside its kernel.  Odd (K-1)*D is
rejected (torch 'same' would be asymmetric).

Bound on the H100: at the vocoder's shapes (Cin = Cout = 256 at T = 7232,
128 at T = 57857, K in {3, 7, 11}) each output does K*Cin multiply-adds per
2*(Cin+Cout) bytes, so the tensor-core rate bounds it.  See the source
note for the design.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from taste_spokenlm_tpu_torch.kernels import _build

_SIGNATURE = {"tsk_conv1d_same": (_build.P,) * 4 + (_build.I,) * 7
               + (_build.P,)}
# the kernel's tiles: (time rows, output channels, warps, input channels a
# chunk) of a CTA
TILES = ((256, 128, 8, 32), (128, 64, 4, 64), (128, 64, 4, 32))


def tile_for(t: int, cin: int, cout: int, sms: int) -> int:
    """The kernel's tile (an index into TILES): 256 x 128 where those tiles
    alone fill the card once (the 128-channel stage at T = 57857), else 128
    x 64 (the 256-channel stage at T = 7232 gives 228 of them), in chunks
    of 64 input channels where Cin allows."""
    if cout % 128 == 0 and -(-t // 256) * (cout // 128) >= sms:
        return 0
    return 1 if cin % 64 == 0 else 2


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
    """x [B, T, Cin], w [K, Cin, Cout], b [Cout] or None -> [B, T, Cout]
    (same padding).  CPU tensors take the plain version; CUDA tensors
    launch csrc/conv1d.cu (bf16 only), bias included."""
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
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("conv1d_same: x and w must be 16-byte aligned")
    if b is not None:
        if b.shape != (cout,) or b.device != x.device:
            raise ValueError(f"conv1d_same: bias {tuple(b.shape)} on "
                             f"{b.device} does not fit Cout={cout}")
        b = b.to(x.dtype).contiguous()
        if b.data_ptr() % 16:
            b = b.clone()
    lib = _build.load("conv1d", _SIGNATURE)
    y = torch.empty((bsz, t, cout), dtype=x.dtype, device=x.device)
    err = lib.tsk_conv1d_same(_build.ptr(x), _build.ptr(w),
                              None if b is None else _build.ptr(b),
                              _build.ptr(y), bsz, t, cin, cout, k, dilation,
                              tile_for(t, cin, cout, _build.sm_count(x.device)),
                              _build.stream_of(x))
    _build.check(err, "conv1d_same")
    conv1d_same.launches += 1
    return y


conv1d_same.launches = 0
