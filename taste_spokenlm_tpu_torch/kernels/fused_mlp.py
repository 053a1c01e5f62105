"""Fused int8 and int4 MLPs: the Llama gated MLP and the conformer
positionwise FFN, each one call with the intermediate activation kept on
chip.

Replaces the TPU kernels ops/pallas/fused_mlp.py:102 `gated_mlp_int8`
(`_gated_kernel_i8`) and :383 `ffn_int8` (`_ffn_kernel_i8`) with
csrc/fused_mlp.cu, and :192 `gated_mlp_int4` (`_gated_kernel_i4`) and :312
`ffn_int4` (`_ffn_kernel_i4`) with csrc/fused_mlp_int4.cu.  Numerics as on
the TPU: x is cast to bf16, the int8 products are summed in f32, the scales
(and the first bias) are applied to the f32 sums, the activation a is
rounded to bf16 before the second product, and the output is f32.  In int4
each (nibble plane, scale group) partial sum is scaled on its own, as
`_dot_int4` does.

The int4 layouts are kernels/int4_matmul.py's, except that the second
projection is packed per tile of `mlp_tile(I)` rows (`quantize_int4_tiled`):
in packed row t*bi/2 + r the low nibble is I-row t*bi + r and the high
nibble I-row t*bi + bi/2 + r, and tile t's scales are rows [t*spt,
(t+1)*spt), low-plane groups first.  Byte-identical to the JAX package's.

Bound on the H100: the weight bytes at decode.  All four are one CUDA
launch a call (csrc/gated_mlp.cuh, the FFNs as its compile-time FFN
variant: thread-block clusters over I, the clusters' partials summed in a
fixed order by the last block to arrive; one row of x on the SIMT units,
more rows on the tensor cores); `gated_plan` picks the route, the cluster,
its columns and the number of clusters, and the kernel's library says how
many partial sums that plan leaves (`gated_geometry`).  `launches` counts
one per call.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from taste_spokenlm_tpu_torch.kernels import _build
from taste_spokenlm_tpu_torch.kernels.int4_matmul import (dequantize_int4,
                                                          quantize_int4)
from taste_spokenlm_tpu_torch.kernels.int4_matmul import \
    matmul_int4_plain as _dot_int4

MLP_TILE = 512
SUB = 32                  # the int8 kernels take I % SUB == 0
_ACTS = {"silu": 0, "swish": 0, "relu": 1, "gelu": 2}
_SIGNATURE = {
    "tsk_gated_mlp_int8": (_build.P,) * 10 + (_build.I,) * 7 + (_build.P,),
    "tsk_gated_geometry_int8": (_build.I,) * 6 + (_build.P,),
    "tsk_ffn_int8": (_build.P,) * 10 + (_build.I,) * 7 + (_build.P,),
    "tsk_ffn_geometry_int8": (_build.I,) * 6 + (_build.P,)}
TILE4 = 32                # the int4 kernels take tile % TILE4 == 0
_SIGNATURE4 = {
    "tsk_gated_mlp_int4": (_build.P,) * 10 + (_build.I,) * 10 + (_build.P,),
    "tsk_gated_geometry_int4": (_build.I,) * 9 + (_build.P,),
    "tsk_ffn_int4": (_build.P,) * 10 + (_build.I,) * 10 + (_build.P,),
    "tsk_ffn_geometry_int4": (_build.I,) * 9 + (_build.P,)}
# the gated kernels (csrc/gated_mlp.cuh): rows of x a block (tensor
# cores), the cluster sizes and columns of I a cluster they take
GATED_ROWS = 16
GATED_CLUSTERS = (1, 2, 4, 8)
GATED_COLS = (128, 256)
GEMV_CLUSTER = 8          # blocks a cluster of the one-row SIMT kernel
MAX_ARRIVALS = 256        # counters a gated kernel keeps per device


def _pick_block(i: int, block_i: int) -> int:
    bi = min(block_i, i)
    while i % bi:
        bi //= 2
    return max(bi, 1)


def mlp_tile(i: int) -> int:
    """The JAX package's intermediate-dim tile (its grid block and the
    per-tile int4 packing stride of the second projection)."""
    return _pick_block(i, MLP_TILE)


def act_fn(name: str):
    if name in ("silu", "swish"):
        return F.silu
    if name == "relu":
        return F.relu
    if name == "gelu":
        return lambda v: F.gelu(v, approximate="tanh")
    raise ValueError(f"unsupported activation {name!r}")


def _rows(x: torch.Tensor, h: int) -> torch.Tensor:
    return x.reshape(-1, h).to(torch.bfloat16).float()


def gated_mlp_int8_plain(x, wg, sg, wu, su, wd, sd, activation: str = "silu"):
    """(act(x Wg sg) (x Wu su)) Wd sd in PyTorch, with the kernel's casts.
    x [..., H]; wg/wu [H, I] int8, sg/su [I]; wd [I, H] int8, sd [H]."""
    lead, h = x.shape[:-1], x.shape[-1]
    xm = _rows(x, h)
    g = (xm @ wg.float()) * sg.float()
    u = (xm @ wu.float()) * su.float()
    a = (act_fn(activation)(g) * u).to(torch.bfloat16).float()
    return ((a @ wd.float()) * sd.float()).reshape(*lead, h)


def ffn_int8_plain(x, w1, s1, b1, w2, s2, b2, activation: str = "swish"):
    """act(x W1 s1 + b1) W2 s2 + b2 in PyTorch, with the kernel's casts.
    x [..., D]; w1 [D, I] int8, s1/b1 [I]; w2 [I, D] int8, s2/b2 [D]."""
    lead, d = x.shape[:-1], x.shape[-1]
    xm = _rows(x, d)
    h = (xm @ w1.float()) * s1.float() + b1.float()
    a = act_fn(activation)(h).to(torch.bfloat16).float()
    return (b2.float() + (a @ w2.float()) * s2.float()).reshape(*lead, d)


def _prepare(fn_name, x, mats, vecs, activation, packed: bool = False):
    """Check what the kernel takes; -> (x as [M, H] bf16, out [M, H] f32).
    mats are the int8 (or, `packed`, the uint8 int4) matrices, vecs the f32
    scales and biases."""
    if activation not in _ACTS:
        raise ValueError(f"{fn_name}: unsupported activation {activation!r}")
    if not packed:
        h, i = x.shape[-1], mats[0].shape[1]
        if h % 8 or i % SUB:
            raise ValueError(f"{fn_name}: needs H % 8 == 0 and I % {SUB} == 0 "
                             f"(got H={h}, I={i})")
        if any(t.dtype != torch.int8 for t in mats):
            raise TypeError(f"{fn_name}: weights must be int8")
    if any(t.dtype != torch.float32 for t in vecs):
        raise TypeError(f"{fn_name}: scales and biases must be float32")
    for t in (*mats, *vecs):
        if t.device != x.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{fn_name}: weights, scales and biases must be "
                             f"contiguous and 16-byte aligned on {x.device}")
    h = x.shape[-1]
    xm = x.reshape(-1, h).to(torch.bfloat16).contiguous()
    out = torch.empty((xm.shape[0], h), dtype=torch.float32, device=x.device)
    return xm, out


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def gated_clusters(i: int, cols: int, tile: Optional[int] = None) -> int:
    """Clusters of a tensor-core plan as `gated_plan` ranks its candidates:
    int8 ceil(I / cols); int4 (`tile` given) the tiles of Wd times
    ceil((tile / 2) / (cols / 2)), each cluster inside one tile.  The
    partial sums are sized from the kernel's own count (`gated_geometry`),
    which a card test holds equal to this one."""
    if tile is None:
        return _cdiv(i, cols)
    return (i // tile) * _cdiv(tile // 2, cols // 2)


def gemv_slots(i: int, cluster: int, sms: int, int4: bool = False) -> int:
    """Clusters of the one-row SIMT kernel: as many as fill 10/11 of the
    SMs once (clusters of 4 or 8 reach 120 of an H100's 132 SMs, one block
    each), at least one 16-column (int4: 16-packed-row) chunk each."""
    return max(1, min(i // 32 if int4 else i // 16,
                      sms * 10 // 11 // cluster))


def gated_plan(m: int, h: int, i: int, sms: int, tile: Optional[int] = None
               ) -> Tuple[int, int, int]:
    """(blocks a cluster, columns of I a cluster, SIMT clusters) of a gated
    kernel; int8, or int4 where `tile` (the Wd packing tile) is given.  One
    row (M = 1) with H % 16 == 0 takes the SIMT kernel (`gemv_slots`
    clusters of GEMV_CLUSTER blocks; the columns are unused), every other M
    the tensor cores in row tiles of GATED_ROWS.

    On the tensor cores the candidates are every cluster of GATED_CLUSTERS
    and every width of GATED_COLS whose ranks own 128, 256 or 512 output
    columns (the widths the kernel is built for) and every one of them
    contraction rows and output columns;
    such a block fits in shared memory (at most about 110 KB of 226, int4
    scales staged only where they fit).  The plan takes the most blocks
    (clusters x ranks x row tiles) that still fit on the card in one wave,
    and among those the fewer columns past I, the wider columns (longer
    weight runs, fewer partials to sum), then the smaller cluster; where
    none fits in one wave, the fewest blocks."""
    int4 = tile is not None
    k1 = h // 2 if int4 else h
    if m == 1 and h % 16 == 0:
        cluster = min(GEMV_CLUSTER, max(1, h // 16))
        return cluster, GATED_COLS[0], gemv_slots(i, cluster, sms, int4)
    best, tiles = None, _cdiv(m, GATED_ROWS)
    for cols in GATED_COLS:
        for cluster in GATED_CLUSTERS:
            kc = _cdiv(_cdiv(k1, cluster), 16) * 16
            hc = _cdiv(_cdiv(h, cluster), 128) * 128
            if kc * (cluster - 1) >= k1 or hc * (cluster - 1) >= h \
                    or hc not in (128, 256, 512):
                continue
            slots = gated_clusters(i, cols, tile)
            blocks = slots * cluster * tiles
            key = ((0, blocks) if blocks <= sms else (-1, -blocks),
                   i - slots * cols, cols, -cluster)
            if best is None or key > best[0]:
                best = (key, (cluster, cols, 0))
    if best is None:
        raise ValueError(f"gated MLP: no plan takes H={h}")
    return best[1]


@functools.lru_cache(maxsize=None)
def _geometry(dims: Tuple[int, ...], plan: Tuple[int, int, int],
              ffn: bool = False) -> Tuple[int, int, int]:
    """(S, the last slot's first row of Wd, row tiles of x) as the kernel
    derives them from the plan."""
    out = (ctypes.c_int * 3)()
    if len(dims) == 3:
        lib = _build.load("fused_mlp", _SIGNATURE)
        fn = lib.tsk_ffn_geometry_int8 if ffn else lib.tsk_gated_geometry_int8
        err = fn(*dims, *plan, ctypes.addressof(out))
    else:
        lib = _build.load("fused_mlp_int4", _SIGNATURE4)
        fn = lib.tsk_ffn_geometry_int4 if ffn else lib.tsk_gated_geometry_int4
        err = fn(*dims, *plan, ctypes.addressof(out))
    if err:
        raise ValueError(f"gated MLP: the kernel cannot take plan {plan} "
                         f"at (M, H, I, ...) = {dims}")
    return out[0], out[1], out[2]


def gated_geometry(m: int, h: int, i: int, sms: int,
                   tile: Optional[int] = None, group_in: int = 1,
                   spt: int = 2, ffn: bool = False
                   ) -> Tuple[Tuple[int, int, int], int, int]:
    """(plan, S, row) of a gated kernel's call on a CUDA device with `sms`
    SMs (int8; int4 where `tile` is given, with the first projection's
    packed rows a scale row and Wd's scale rows a tile; `ffn`: the
    conformer FFN on the same kernels, one first-projection matrix): the
    plan `gated_plan` picks, and as the kernel derives them from it
    (tsk_gated_geometry_int8 / _int4, tsk_ffn_geometry_int8 / _int4) the S
    slots of its partial sums and the first row of Wd (W2) that slot S - 1
    owns (int4: a packed row of the per-tile packing).  Raises where the
    kernel cannot take the plan."""
    plan = gated_plan(m, h, i, sms, tile)
    dims = (m, h, i) if tile is None else (m, h, i, tile, group_in, spt)
    slots, row, _ = _geometry(dims, plan, ffn)
    return plan, slots, row


def _gated_buffers(kind: str, m: int, h: int, slots: int, cluster: int,
                   device):
    """(partials [slots, M, H] f32, arrival counters) of one gated call;
    None, None with one slot."""
    if slots == 1:
        return None, None
    if _cdiv(m, GATED_ROWS) * cluster > MAX_ARRIVALS:
        raise ValueError(f"{kind}: {m} rows need more than {MAX_ARRIVALS} "
                         f"arrival counters")
    part = torch.empty((slots, m, h), dtype=torch.float32, device=device)
    return part, _build.arrivals(kind, device, MAX_ARRIVALS)


def _opt_ptr(t) -> Optional[int]:
    return None if t is None else _build.ptr(t)


def gated_mlp_int8(x, wg, sg, wu, su, wd, sd, activation: str = "silu"):
    """The Llama MLP, -> [..., H] f32.  CPU tensors take the plain version;
    CUDA tensors launch csrc/fused_mlp.cu (one launch)."""
    if x.device.type == "cpu":
        return gated_mlp_int8_plain(x, wg, sg, wu, su, wd, sd, activation)
    if x.device.type != "cuda":
        raise ValueError(f"gated_mlp_int8: unsupported device {x.device}")
    h, i = wg.shape
    if x.shape[-1] != h or wu.shape != (h, i) or wd.shape != (i, h) \
            or sg.shape != (i,) or su.shape != (i,) or sd.shape != (h,):
        raise ValueError("gated_mlp_int8: shapes do not fit")
    xm, out = _prepare("gated_mlp_int8", x, (wg, wu, wd), (sg, su, sd),
                       activation)
    m = xm.shape[0]
    if m:
        plan, slots, _ = gated_geometry(m, h, i, _build.sm_count(x.device))
        part, arrivals = _gated_buffers("gated_mlp_int8", m, h, slots,
                                        plan[0], x.device)
        lib = _build.load("fused_mlp", _SIGNATURE)
        p = _build.ptr
        err = lib.tsk_gated_mlp_int8(
            p(xm), p(wg), p(sg), p(wu), p(su), p(wd), p(sd), _opt_ptr(part),
            p(out), _opt_ptr(arrivals), m, h, i, _ACTS[activation], *plan,
            _build.stream_of(x))
        _build.check(err, "gated_mlp_int8")
        gated_mlp_int8.launches += 1
    return out.reshape(*x.shape[:-1], h)


def ffn_int8(x, w1, s1, b1, w2, s2, b2, activation: str = "swish"):
    """The conformer FFN, -> [..., D] f32.  CPU tensors take the plain
    version; CUDA tensors launch csrc/fused_mlp.cu (one launch, the gated
    kernels' FFN variant under `gated_plan`'s plan)."""
    if x.device.type == "cpu":
        return ffn_int8_plain(x, w1, s1, b1, w2, s2, b2, activation)
    if x.device.type != "cuda":
        raise ValueError(f"ffn_int8: unsupported device {x.device}")
    d, i = w1.shape
    if x.shape[-1] != d or w2.shape != (i, d) or s1.shape != (i,) \
            or b1.shape != (i,) or s2.shape != (d,) or b2.shape != (d,):
        raise ValueError("ffn_int8: shapes do not fit")
    xm, out = _prepare("ffn_int8", x, (w1, w2), (s1, b1, s2, b2), activation)
    m = xm.shape[0]
    if m:
        plan, slots, _ = gated_geometry(m, d, i, _build.sm_count(x.device),
                                        ffn=True)
        part, arrivals = _gated_buffers("ffn_int8", m, d, slots, plan[0],
                                        x.device)
        lib = _build.load("fused_mlp", _SIGNATURE)
        p = _build.ptr
        err = lib.tsk_ffn_int8(
            p(xm), p(w1), p(s1), p(b1), p(w2), p(s2), p(b2), _opt_ptr(part),
            p(out), _opt_ptr(arrivals), m, d, i, _ACTS[activation], *plan,
            _build.stream_of(x))
        _build.check(err, "ffn_int8")
        ffn_int8.launches += 1
    return out.reshape(*x.shape[:-1], d)


gated_mlp_int8.launches = 0
ffn_int8.launches = 0


# ---------------------------------------------------------------------------
# int4: the first projection in kernels/int4_matmul.py's layout, the second
# packed per tile
# ---------------------------------------------------------------------------


def quantize_int4_tiled(w: torch.Tensor, tile: int, group=None):
    """[I, H] float -> (packed [I/2, H] uint8, scales [I/tile * spt, H] f32):
    quantize_int4 applied tile by tile along I, in tile order."""
    i = w.shape[0]
    if i % tile:
        raise ValueError(f"quantize_int4_tiled: I = {i} is not a multiple "
                         f"of the tile {tile}")
    parts = [quantize_int4(w[t:t + tile], group) for t in range(0, i, tile)]
    return (torch.cat([p for p, _ in parts]), torch.cat([s for _, s in parts]))


def dequantize_int4_tiled(wp: torch.Tensor, scale: torch.Tensor, tile: int
                          ) -> torch.Tensor:
    """Inverse of quantize_int4_tiled: -> [I, H] f32."""
    n_tiles = 2 * wp.shape[0] // tile
    th, spt = tile // 2, scale.shape[0] // n_tiles
    return torch.cat([dequantize_int4(wp[t * th:(t + 1) * th],
                                      scale[t * spt:(t + 1) * spt])
                      for t in range(n_tiles)])


def _tiled_dot(a: torch.Tensor, wp: torch.Tensor, scale: torch.Tensor,
               tile: int, out: torch.Tensor) -> torch.Tensor:
    """out + a @ dequant(per-tile packed wp), one tile at a time in order,
    as the TPU kernel's grid accumulates it."""
    n_tiles = a.shape[1] // tile
    th, spt = tile // 2, scale.shape[0] // n_tiles
    for t in range(n_tiles):
        out = out + _dot_int4(a[:, t * tile:(t + 1) * tile],
                              wp[t * th:(t + 1) * th],
                              scale[t * spt:(t + 1) * spt])
    return out


def gated_mlp_int4_plain(x, wg, sg, wu, su, wd, sd, activation: str = "silu",
                         tile=None):
    """(act(x Wg) (x Wu)) Wd in PyTorch, with the kernel's casts.  x [...,
    H]; wg/wu packed [H/2, I] uint8 with scales [H/g, I]; wd packed per tile
    [I/2, H] with scales [I/g', H]; tile defaults to mlp_tile(I)."""
    lead, h = x.shape[:-1], x.shape[-1]
    i = wg.shape[1]
    xm = _rows(x, h)
    a = (act_fn(activation)(_dot_int4(xm, wg, sg)) * _dot_int4(xm, wu, su)
         ).to(torch.bfloat16).float()
    out = _tiled_dot(a, wd, sd, tile or mlp_tile(i), xm.new_zeros(xm.shape))
    return out.reshape(*lead, h)


def ffn_int4_plain(x, w1, s1, b1, w2, s2, b2, activation: str = "swish",
                   tile=None):
    """act(x W1 + b1) W2 + b2 in PyTorch, with the kernel's casts.  x [...,
    D]; w1 packed [D/2, I] with scales [D/g, I], b1 [I]; w2 packed per tile
    [I/2, D] with scales [I/g', D], b2 [D]."""
    lead, d = x.shape[:-1], x.shape[-1]
    i = w1.shape[1]
    xm = _rows(x, d)
    a = act_fn(activation)(_dot_int4(xm, w1, s1) + b1.float()
                           ).to(torch.bfloat16).float()
    out = _tiled_dot(a, w2, s2, tile or mlp_tile(i),
                     b2.float().expand(xm.shape[0], d))
    return out.reshape(*lead, d)


def _int4_geometry(fn_name, x, w1, s1, w2, s2, tile):
    """Check the int4 layouts; -> (H, I, tile, first-projection group,
    scale rows per tile)."""
    h, i = x.shape[-1], w1.shape[1]
    tile = tile or mlp_tile(i)
    if w1.shape != (h // 2, i) or w2.shape != (i // 2, h) or h % 2:
        raise ValueError(f"{fn_name}: packed weights {tuple(w1.shape)} and "
                         f"{tuple(w2.shape)} do not fit x [..., {h}]")
    if h % 4 or i % tile or tile % TILE4:
        raise ValueError(f"{fn_name}: needs H % 4 == 0, I % tile == 0 and "
                         f"tile % {TILE4} == 0 (H={h}, I={i}, tile={tile})")
    n_in, n_tiles = s1.shape[0], i // tile
    if s1.shape != (n_in, i) or n_in % 2 or (h // 2) % (n_in // 2) \
            or s2.dim() != 2 or s2.shape[1] != h or s2.shape[0] % n_tiles:
        raise ValueError(f"{fn_name}: scales {tuple(s1.shape)} and "
                         f"{tuple(s2.shape)} do not fit")
    spt = s2.shape[0] // n_tiles
    if spt % 2 or (tile // 2) % (spt // 2):
        raise ValueError(f"{fn_name}: {spt} scale rows per tile of {tile}")
    if any(t.dtype != torch.uint8 for t in (w1, w2)):
        raise TypeError(f"{fn_name}: packed weights must be uint8")
    return h, i, tile, (h // 2) // (n_in // 2), spt


def gated_mlp_int4(x, wg, sg, wu, su, wd, sd, activation: str = "silu",
                   tile=None):
    """The int4 Llama MLP, -> [..., H] f32.  CPU tensors take the plain
    version; CUDA tensors launch csrc/fused_mlp_int4.cu (one launch)."""
    if x.device.type == "cpu":
        return gated_mlp_int4_plain(x, wg, sg, wu, su, wd, sd, activation,
                                    tile)
    if x.device.type != "cuda":
        raise ValueError(f"gated_mlp_int4: unsupported device {x.device}")
    if wu.shape != wg.shape or su.shape != sg.shape:
        raise ValueError("gated_mlp_int4: gate and up do not fit")
    if wu.dtype != torch.uint8:
        raise TypeError("gated_mlp_int4: packed weights must be uint8")
    h, i, tile, group_in, spt = _int4_geometry("gated_mlp_int4", x, wg, sg,
                                               wd, sd, tile)
    xm, out = _prepare("gated_mlp_int4", x, (wg, wu, wd), (sg, su, sd),
                       activation, packed=True)
    m = xm.shape[0]
    if m:
        plan, slots, _ = gated_geometry(m, h, i, _build.sm_count(x.device),
                                        tile, group_in, spt)
        part, arrivals = _gated_buffers("gated_mlp_int4", m, h, slots,
                                        plan[0], x.device)
        lib = _build.load("fused_mlp_int4", _SIGNATURE4)
        p = _build.ptr
        err = lib.tsk_gated_mlp_int4(
            p(xm), p(wg), p(sg), p(wu), p(su), p(wd), p(sd), _opt_ptr(part),
            p(out), _opt_ptr(arrivals), m, h, i, tile, group_in, spt,
            _ACTS[activation], *plan, _build.stream_of(x))
        _build.check(err, "gated_mlp_int4")
        gated_mlp_int4.launches += 1
    return out.reshape(*x.shape[:-1], h)


def ffn_int4(x, w1, s1, b1, w2, s2, b2, activation: str = "swish", tile=None):
    """The int4 conformer FFN, -> [..., D] f32.  CPU tensors take the plain
    version; CUDA tensors launch csrc/fused_mlp_int4.cu (one launch, the
    gated kernels' FFN variant under `gated_plan`'s plan)."""
    if x.device.type == "cpu":
        return ffn_int4_plain(x, w1, s1, b1, w2, s2, b2, activation, tile)
    if x.device.type != "cuda":
        raise ValueError(f"ffn_int4: unsupported device {x.device}")
    if b1.shape != (w1.shape[1],) or b2.shape != (x.shape[-1],):
        raise ValueError("ffn_int4: biases do not fit")
    d, i, tile, group_in, spt = _int4_geometry("ffn_int4", x, w1, s1, w2, s2,
                                               tile)
    xm, out = _prepare("ffn_int4", x, (w1, w2), (s1, b1, s2, b2), activation,
                       packed=True)
    m = xm.shape[0]
    if m:
        plan, slots, _ = gated_geometry(m, d, i, _build.sm_count(x.device),
                                        tile, group_in, spt, ffn=True)
        part, arrivals = _gated_buffers("ffn_int4", m, d, slots, plan[0],
                                        x.device)
        lib = _build.load("fused_mlp_int4", _SIGNATURE4)
        p = _build.ptr
        err = lib.tsk_ffn_int4(
            p(xm), p(w1), p(s1), p(b1), p(w2), p(s2), p(b2), _opt_ptr(part),
            p(out), _opt_ptr(arrivals), m, d, i, tile, group_in, spt,
            _ACTS[activation], *plan, _build.stream_of(x))
        _build.check(err, "ffn_int4")
        ffn_int4.launches += 1
    return out.reshape(*x.shape[:-1], d)


gated_mlp_int4.launches = 0
ffn_int4.launches = 0
