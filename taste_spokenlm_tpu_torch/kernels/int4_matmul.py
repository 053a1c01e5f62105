"""int4 weight-only product x @ dequant(w), and the int4 packing.

Replaces the TPU kernel ops/pallas/int4_matmul.py:114 `matmul_int4`
(`_kernel`) with csrc/int4_matmul.cu.  The packed layout is byte-identical
to the JAX package's: w [D, N] (int4 values in [-8, 7]) is stored as
[D/2, N] uint8 whose low nibble holds rows [0, D/2) and high nibble rows
[D/2, D), two's complement; the group-wise f32 scales [D/group, N] put the
low-half groups first.  x is cast to bf16 and the output is f32, as on the
TPU.

Bound on the H100: the bytes (the packed weights and their scales); see the
source note for the design.  `launches` counts CUDA launches only.
"""

from __future__ import annotations

from typing import Optional

import torch

from taste_spokenlm_tpu_torch.kernels import _build

DEFAULT_GROUP = 128
_SIGNATURE = {"tsk_matmul_int4": (_build.P, _build.P, _build.P, _build.P,
                                  _build.I, _build.I, _build.I, _build.I,
                                  _build.I, _build.P)}


def _group(d: int, group: Optional[int] = None) -> int:
    """Rows per scale: the largest divisor of D/2 not above `group`."""
    g = min(group or DEFAULT_GROUP, d // 2)
    while (d // 2) % g:
        g -= 1
    return g


def pack_int4(w: torch.Tensor) -> torch.Tensor:
    """[D, N] int (values in [-8, 7]) -> packed [D/2, N] uint8."""
    d = w.shape[0]
    if d % 2:
        raise ValueError(f"pack_int4: D = {d} is odd")
    lo = w[: d // 2].to(torch.int32) & 0xF
    hi = w[d // 2:].to(torch.int32) & 0xF
    return (lo | (hi << 4)).to(torch.uint8)


def unpack_int4(wp: torch.Tensor) -> torch.Tensor:
    """Inverse of pack_int4: [D/2, N] uint8 -> [D, N] int8, sign-extended."""
    b = wp.to(torch.int32)
    lo = ((b << 28) >> 28).to(torch.int8)
    hi = ((b << 24) >> 28).to(torch.int8)
    return torch.cat([lo, hi], dim=0)


def quantize_int4(w: torch.Tensor, group: Optional[int] = None):
    """f32 [D, N] -> (packed [D/2, N] uint8, scale [D/g, N] f32): symmetric
    group-wise scales in the packed plane order."""
    d, n = w.shape
    g = _group(d, group)
    wg = w.float().reshape(d // g, g, n)
    scale = torch.clamp(wg.abs().amax(dim=1), min=1e-8) / 7.0
    q = torch.clamp(torch.round(wg / scale[:, None, :]), -8, 7)
    return pack_int4(q.reshape(d, n).to(torch.int8)), scale


def dequantize_int4(wp: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """(packed, group scales) -> [D, N] f32."""
    q = unpack_int4(wp).float()
    d, n = q.shape
    n_g = scale.shape[0]
    return (q.reshape(n_g, d // n_g, n) * scale.float()[:, None, :]).reshape(d, n)


def matmul_int4_plain(x: torch.Tensor, wp: torch.Tensor, scale: torch.Tensor
                      ) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch: per plane and scale group, the
    bf16 x slice times the exact nibble values with f32 sums, scaled on the
    f32 result.  x [..., D], wp [D/2, N], scale [D/group, N] -> [..., N] f32."""
    lead, d = x.shape[:-1], x.shape[-1]
    half, n = wp.shape
    n_g = scale.shape[0] // 2
    g = half // n_g
    xm = x.reshape(-1, d).to(torch.bfloat16).float()
    q = unpack_int4(wp).float()
    acc = None
    for plane in range(2):
        for gi in range(n_g):
            r0 = plane * half + gi * g
            part = (xm[:, r0:r0 + g] @ q[r0:r0 + g]) * scale[plane * n_g + gi].float()
            acc = part if acc is None else acc + part
    return acc.reshape(*lead, n)


def matmul_int4(x: torch.Tensor, wp: torch.Tensor, scale: torch.Tensor
                ) -> torch.Tensor:
    """x [..., D] @ dequant(wp [D/2, N] uint8, scale [D/group, N] f32) ->
    [..., N] f32.  CPU tensors take the plain version; CUDA tensors launch
    csrc/int4_matmul.cu."""
    if x.device.type == "cpu":
        return matmul_int4_plain(x, wp, scale)
    if x.device.type != "cuda":
        raise ValueError(f"matmul_int4: unsupported device {x.device}")
    lead, d = x.shape[:-1], x.shape[-1]
    half, n = wp.shape
    if wp.dtype != torch.uint8 or scale.dtype != torch.float32:
        raise TypeError("matmul_int4: needs uint8 packed weights and float32 "
                        "scales")
    if 2 * half != d or scale.dim() != 2 or scale.shape[1] != n \
            or scale.shape[0] % 2 or half % (scale.shape[0] // 2):
        raise ValueError(f"matmul_int4: x [..., {d}], packed {tuple(wp.shape)} "
                         f"and scales {tuple(scale.shape)} do not fit")
    for t in (wp, scale):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("matmul_int4: weights and scales must be "
                             "contiguous on the device of x")
    xm = x.reshape(-1, d).to(torch.bfloat16).contiguous()
    m = xm.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0:
        return out.reshape(*lead, n)
    group = half // (scale.shape[0] // 2)
    vec = int(n % 4 == 0 and wp.data_ptr() % 4 == 0)
    lib = _build.load("int4_matmul", _SIGNATURE)
    err = lib.tsk_matmul_int4(_build.ptr(xm), _build.ptr(wp), _build.ptr(scale),
                              _build.ptr(out), m, d, n, group, vec,
                              _build.stream_of(x))
    _build.check(err, "matmul_int4")
    matmul_int4.launches += 1
    return out.reshape(*lead, n)


matmul_int4.launches = 0
