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
`launches` counts one per call (`matmul_int8`: two CUDA launches where the
contraction is split).
"""

from __future__ import annotations

import torch

from taste_spokenlm_tpu_torch.kernels import _build

TILE_N = 256              # matmul_int8: columns a block owns (kernel)
MIN_SLICE, MAX_SLICE = 64, 2048
_SIGNATURE = {
    "tsk_logits_int8": (_build.P,) * 4 + (_build.I,) * 3 + (_build.P,),
    "tsk_matmul_int8": (_build.P,) * 5 + (_build.I,) * 5 + (_build.P,),
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


def split_rows(m: int, d: int, n: int, device) -> int:
    """Contraction rows per slice of matmul_int8's first pass: enough slices
    that about four blocks run per SM over all column and row tiles, each
    a multiple of 8 rows (one per warp), at least MIN_SLICE and at most
    MAX_SLICE (its rows of x sit in shared memory)."""
    tiles = -(-n // TILE_N) * (1 if m <= 8 else -(-m // 8))
    want = max(1, 4 * _build.sm_count(device) // tiles)
    rows = -(-d // want)
    rows = -(-rows // 8) * 8
    return min(max(rows, MIN_SLICE), MAX_SLICE)


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
        rows = split_rows(m, d, n, x.device)
        n_split = -(-d // rows)
        part = torch.empty((n_split, m, n) if n_split > 1 else (0,),
                           dtype=torch.float32, device=x.device)
        vec = int(n % 8 == 0 and w_q.data_ptr() % 8 == 0)
        lib = _build.load("int8_matmul", _SIGNATURE)
        err = lib.tsk_matmul_int8(_build.ptr(xm), _build.ptr(w_q),
                                  _build.ptr(scale), _build.ptr(part),
                                  _build.ptr(out), m, d, n, rows, vec,
                                  _build.stream_of(x))
        _build.check(err, "matmul_int8")
        matmul_int8.launches += 1
    return out.reshape(*x.shape[:-1], n)


logits_int8.launches = 0
matmul_int8.launches = 0
