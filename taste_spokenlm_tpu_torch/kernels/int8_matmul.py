"""int8 weight-only products for decode steps, in the two layouts of the
TPU file: the tied-head table [V, D] with per-row scales, and the Dense
kernel [D, N] with per-column scales.

Replaces the TPU kernels ops/pallas/int8_matmul.py:46 `logits_int8`
(`_logits_kernel`) and :90 `matmul_int8` (`_matmul_kernel`) with
csrc/int8_matmul.cu.  Numerics as on the TPU: x is cast to bf16, the int8
weights become bf16 exactly, the products are summed in f32, the scale
multiplies the f32 sum, and the output is f32 with x's leading dims.  The
JAX block sizes (`block_v`, `block_n`) and `interpret` are TPU tiling and
have no counterpart here.

Bound on the H100: the weight bytes; see the source note for the design.
`matmul_int8` is one CUDA launch for every shape: where `split_plan` splits
the contraction, the last block on a column tile adds the slices' partials
in a fixed order, so two calls give the same bits.  `launches` counts one
per call.
"""

from __future__ import annotations

from typing import Tuple

import torch

from taste_spokenlm_tpu_torch.kernels import _build

ROW_STEP = 8              # matmul_int8: slices are multiples of it
SPLIT_SLICES = 8          # matmul_int8 at M = 1: slices of a split
MAX_ARRIVALS = 4096       # matmul_int8: arrival counters of a device
_SIGNATURE = {
    "tsk_logits_int8": (_build.P,) * 4 + (_build.I,) * 3 + (_build.P,),
    "tsk_matmul_int8": (_build.P,) * 6 + (_build.I,) * 7 + (_build.P,),
}


def _rows(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1, x.shape[-1]).to(torch.bfloat16).float()


def logits_int8_plain(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor
                      ) -> torch.Tensor:
    """(x . w_q[v]) * scale[v] with the kernel's casts.  x [..., D], w_q
    [V, D] int8, scale [V] -> [..., V] f32."""
    out = (_rows(x) @ w_q.float().T) * scale.float()
    return out.reshape(*x.shape[:-1], w_q.shape[0])


def matmul_int8_plain(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor
                      ) -> torch.Tensor:
    """(x @ w_q) * scale with the kernel's casts.  x [..., D], w_q [D, N]
    int8, scale [N] -> [..., N] f32."""
    out = (_rows(x) @ w_q.float()) * scale.float()
    return out.reshape(*x.shape[:-1], w_q.shape[1])


def _check(fn_name: str, x, w_q, scale, n_out: int, align: int) -> None:
    if w_q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"{fn_name}: needs int8 weights and float32 scales")
    if scale.shape != (n_out,):
        raise ValueError(f"{fn_name}: scale {tuple(scale.shape)} does not fit "
                         f"weights {tuple(w_q.shape)}")
    for t in (w_q, scale):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{fn_name}: weights and scales must be "
                             f"contiguous on the device of x")
    if w_q.data_ptr() % align:
        raise ValueError(f"{fn_name}: weights must be {align}-byte aligned")


def logits_int8(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor
                ) -> torch.Tensor:
    """x [..., D] against the int8 table w_q [V, D] with per-row scales [V]
    -> [..., V] f32.  CPU tensors take the plain version; CUDA tensors
    launch csrc/int8_matmul.cu."""
    if x.device.type == "cpu":
        return logits_int8_plain(x, w_q, scale)
    if x.device.type != "cuda":
        raise ValueError(f"logits_int8: unsupported device {x.device}")
    if w_q.dim() != 2 or x.shape[-1] != w_q.shape[1]:
        raise ValueError(f"logits_int8: x [..., {x.shape[-1]}] does not fit "
                         f"the table {tuple(w_q.shape)}")
    v, d = w_q.shape
    if d % 16:
        raise ValueError(f"logits_int8: needs D % 16 == 0 (got D={d})")
    _check("logits_int8", x, w_q, scale, v, 16)
    xm = x.reshape(-1, d).to(torch.bfloat16).contiguous()
    out = torch.empty((xm.shape[0], v), dtype=torch.float32, device=x.device)
    if xm.shape[0] and v:
        lib = _build.load("int8_matmul", _SIGNATURE)
        err = lib.tsk_logits_int8(_build.ptr(xm), _build.ptr(w_q),
                                  _build.ptr(scale), _build.ptr(out),
                                  xm.shape[0], d, v, _build.stream_of(x))
        _build.check(err, "logits_int8")
        logits_int8.launches += 1
    return out.reshape(*x.shape[:-1], v)


def split_plan(m: int, d: int, n: int, sms: int) -> Tuple[int, int, int]:
    """(bytes a lane loads from a weight row, threads a block, contraction
    rows a slice) of matmul_int8.  A block has 8 lanes across its columns
    and threads / 8 across the slice's rows, and MT = 1, 2 or 4 rows of x
    (M = 1, 2, else 4 a row tile).

    M = 1, from timings of every path shape on an H100: one slice where a
    lane walks at most 16 rows in a block of 512 (D <= 1024), or where D <=
    2048 and the 4-byte lanes' column tiles fill at least half the card.
    It takes the narrowest lanes (4, 8 or 16 bytes) whose column tiles fit
    in one wave, in blocks of 512 threads, or 1024 (512 with 16-byte
    lanes) at D > 1024; with more tiles than SMs even at 16 bytes, blocks
    of 512, or 128 where the tiles fill the card twice.  Otherwise (few
    column tiles over a long contraction) 16-byte lanes and SPLIT_SLICES
    slices, or fewer where the tiles times slices would pass the SMs, with
    about 8 rows a lane in blocks of 128-512: the last block's sum costs
    less than the idle SMs of one slice.  At M > 1 (16 / MT bytes a lane)
    blocks of 128 threads and as few slices as give about four blocks a
    SM, one where the tiles alone fill the card or would overrun the
    arrival counters.  Slices are multiples of
    ROW_STEP rows: [s * rows, min((s + 1) * rows, D)), s < ceil(D / rows).
    """
    def step(r):
        return -(-r // ROW_STEP) * ROW_STEP

    if m == 1:
        tiles = {c: -(-n // (8 * c)) for c in (4, 8, 16)}
        if d <= 1024 or (d <= 2048 and 2 * tiles[4] >= sms):
            for cols in (4, 8, 16):
                if tiles[cols] <= sms:
                    wide = d > 1024 and cols < 16
                    return cols, 1024 if wide else 512, step(d)
            return 16, 512 if tiles[16] < 2 * sms else 128, step(d)
        slices = max(1, min(SPLIT_SLICES, sms // tiles[16]))
        rows = step(-(-d // slices))
        threads = 128
        while threads < 512 and threads < rows:
            threads *= 2
        return 16, threads, rows
    mt = 2 if m == 2 else 4
    cols = 16 // mt
    tiles = -(-n // (8 * cols)) * -(-m // mt)
    want = 1 if tiles > MAX_ARRIVALS else max(1, 4 * sms // tiles)
    return cols, 128, step(-(-d // want))


def matmul_int8(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor
                ) -> torch.Tensor:
    """x [..., D] @ w_q [D, N] int8 with per-column scales [N] -> [..., N]
    f32.  CPU tensors take the plain version; CUDA tensors launch
    csrc/int8_matmul.cu."""
    if x.device.type == "cpu":
        return matmul_int8_plain(x, w_q, scale)
    if x.device.type != "cuda":
        raise ValueError(f"matmul_int8: unsupported device {x.device}")
    if w_q.dim() != 2 or x.shape[-1] != w_q.shape[0]:
        raise ValueError(f"matmul_int8: x [..., {x.shape[-1]}] does not fit "
                         f"the weights {tuple(w_q.shape)}")
    d, n = w_q.shape
    _check("matmul_int8", x, w_q, scale, n, 1)
    xm = x.reshape(-1, d).to(torch.bfloat16).contiguous()
    m = xm.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m and n:
        cols, threads, rows = split_plan(m, d, n, _build.sm_count(x.device))
        part = arrivals = None
        if rows < d:
            part = torch.empty((-(-d // rows), m, n), dtype=torch.float32,
                               device=x.device)
            arrivals = _build.arrivals("matmul_int8", x.device,
                                       MAX_ARRIVALS)
        vec = int(n % cols == 0 and w_q.data_ptr() % cols == 0)
        lib = _build.load("int8_matmul", _SIGNATURE)
        err = lib.tsk_matmul_int8(
            _build.ptr(xm), _build.ptr(w_q), _build.ptr(scale),
            None if part is None else _build.ptr(part), _build.ptr(out),
            None if arrivals is None else _build.ptr(arrivals), m, d, n, rows,
            cols, threads, vec, _build.stream_of(x))
        _build.check(err, "matmul_int8")
        matmul_int8.launches += 1
    return out.reshape(*x.shape[:-1], n)


logits_int8.launches = 0
matmul_int8.launches = 0
