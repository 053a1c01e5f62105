"""int4 weight-only product x @ dequant(w), and the int4 packing.

Replaces the TPU kernel ops/pallas/int4_matmul.py:114 `matmul_int4`
(`_kernel`) with csrc/int4_matmul.cu.  The packed layout is byte-identical
to the JAX package's: w [D, N] (int4 values in [-8, 7]) is stored as
[D/2, N] uint8 whose low nibble holds rows [0, D/2) and high nibble rows
[D/2, D), two's complement; the group-wise f32 scales [D/group, N] put the
low-half groups first.  x is cast to bf16 and the output is f32, as on the
TPU.

Bound on the H100: the bytes (the packed weights and their scales).  At
M <= 8 the kernel shares the contraction among the warps of a block and,
where the column tiles are too few to fill the card, over blocks on
scale-group edges, with the columns a lane owns narrowed to make more
tiles (`split_plan` picks all three); the last block to arrive on a column
tile adds the slices' partials in a fixed order, so two calls give the
same bits.  Larger M takes row tiles of 8.  See the source note for the
design.  `launches` counts CUDA launches only: one a call.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from taste_spokenlm_tpu_torch.kernels import _build

DEFAULT_GROUP = 128
SPLIT_MAX_ROWS = 8        # rows of x up to which the contraction is split
WIDE_THREADS = 512        # threads of a split block at M = 1 (else 128)
MAX_ARRIVALS = 4096       # arrival counters of a device (column x row tiles)
_SIGNATURE = {"tsk_matmul_int4": (_build.P,) * 6 + (_build.I,) * 8
              + (_build.P,)}


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


def split_plan(m: int, d: int, n: int, group: int, sms: int
               ) -> Tuple[int, int, int]:
    """(bytes a lane loads from a packed row, threads a block, packed rows a
    slice) of the split kernel at M = m <= SPLIT_MAX_ROWS.  A block has 8
    lanes across its columns and threads / 8 across the slice's rows.

    M = 1 takes blocks of 512 threads: as few slices as leave each lane at
    most 16 rows, and the narrowest lanes (4, 8 or 16 bytes) whose column
    tiles times slices still fit in one block a SM, so that the block's
    warps, not a second block, share the contraction (the card's small
    projections then need no partials at all).  Where even 16-byte lanes
    give more tiles than that (the head), and at M = 2..8 (16 / MT bytes a
    lane for MT = 2, 4 rows of x), blocks of 128 threads and as few slices
    as give about four blocks a SM, one where the tiles alone fill the card.
    The slices are whole scale groups: [s * rows, min((s + 1) * rows, D/2)),
    s < ceil(D/2 / rows)."""
    half, n_g = d // 2, d // 2 // group
    if m == 1:
        per = -(-n_g // min(-(-half // (WIDE_THREADS // 8 * 16)), n_g))
        slices = -(-n_g // per)
        for cols in (4, 8, 16):
            if -(-n // (8 * cols)) * slices <= sms:
                return cols, WIDE_THREADS, per * group
    mt = 1 if m == 1 else 2 if m == 2 else 4
    cols = 16 // mt
    tiles = -(-n // (8 * cols)) * -(-m // mt)
    want = min(max(1, 4 * sms // tiles), n_g)
    return cols, 128, -(-n_g // want) * group


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
    part = arrivals = None
    cols = threads = rows = 0
    if m <= SPLIT_MAX_ROWS:
        cols, threads, rows = split_plan(m, d, n, group,
                                         _build.sm_count(x.device))
        if rows < half:        # split: then the tiles are at most 2 a SM
            part = torch.empty((-(-half // rows), m, n), dtype=torch.float32,
                               device=x.device)
            arrivals = _build.arrivals("matmul_int4", x.device,
                                       MAX_ARRIVALS)
        vec = int(n % cols == 0 and wp.data_ptr() % cols == 0)
    else:
        vec = int(n % 4 == 0 and wp.data_ptr() % 4 == 0)
    lib = _build.load("int4_matmul", _SIGNATURE)
    err = lib.tsk_matmul_int4(
        _build.ptr(xm), _build.ptr(wp), _build.ptr(scale),
        None if part is None else _build.ptr(part), _build.ptr(out),
        None if arrivals is None else _build.ptr(arrivals), m, d, n, group,
        rows, cols, threads, vec, _build.stream_of(x))
    _build.check(err, "matmul_int4")
    matmul_int4.launches += 1
    return out.reshape(*lead, n)


matmul_int4.launches = 0
