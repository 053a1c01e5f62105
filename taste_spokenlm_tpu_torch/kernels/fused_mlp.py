"""Fused int8 MLPs: the Llama gated MLP and the conformer positionwise FFN,
each one call with the intermediate activation kept on chip.

Replaces the TPU kernels ops/pallas/fused_mlp.py:102 `gated_mlp_int8`
(`_gated_kernel_i8`) and :383 `ffn_int8` (`_ffn_kernel_i8`) with
csrc/fused_mlp.cu.  Numerics as on the TPU: x is cast to bf16, the int8
products are summed in f32, the scales (and the first bias) are applied to
the f32 sums, the activation a is rounded to bf16 before the second
product, and the output is f32.

Bound on the H100: the weight bytes at decode; see the source note for the
design (a split over I with a deterministic second pass instead of the
TPU's sequential grid).  `launches` counts one per call (two CUDA launches).
The int4 variants (`gated_mlp_int4`, `ffn_int4`) belong to the int4 tier,
ROADMAP.md queue B.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from taste_spokenlm_tpu_torch.kernels import _build

MLP_TILE = 512
SUB = 32                  # I columns per first-projection subtile (kernel)
_ACTS = {"silu": 0, "swish": 0, "relu": 1, "gelu": 2}
_SIG = (_build.P,) * 9 + (_build.I,) * 5 + (_build.P,)
_SIGNATURE = {"tsk_gated_mlp_int8": _SIG, "tsk_ffn_int8": _SIG}


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


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _splits(m: int, i: int, device) -> int:
    """How many I ranges pass 1 splits into: the most (each a multiple of
    SUB columns) with about two blocks per SM over all row tiles."""
    tiles = 1 if m == 1 else -(-m // 8)
    target = 2 * _sm_count(device.index or 0)
    n_sub = i // SUB
    return max(d for d in range(1, n_sub + 1)
               if n_sub % d == 0 and (d * tiles <= target or d == 1))


def _prepare(fn_name, x, mats, vecs, activation):
    """Check what the kernel takes; -> (x as [M, H] bf16, out [M, H] f32,
    scratch [S, M, H] f32).  mats are the int8 matrices, vecs the f32
    scales and biases."""
    h, i = x.shape[-1], mats[0].shape[1]
    if activation not in _ACTS:
        raise ValueError(f"{fn_name}: unsupported activation {activation!r}")
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
    xm = x.reshape(-1, h).to(torch.bfloat16).contiguous()
    m = xm.shape[0]
    out = torch.empty((m, h), dtype=torch.float32, device=x.device)
    s = _splits(m, i, x.device) if m else 1
    part = torch.empty((s, m, h), dtype=torch.float32, device=x.device)
    return xm, out, part


def gated_mlp_int8(x, wg, sg, wu, su, wd, sd, activation: str = "silu"):
    """The Llama MLP, -> [..., H] f32.  CPU tensors take the plain version;
    CUDA tensors launch csrc/fused_mlp.cu."""
    if x.device.type == "cpu":
        return gated_mlp_int8_plain(x, wg, sg, wu, su, wd, sd, activation)
    if x.device.type != "cuda":
        raise ValueError(f"gated_mlp_int8: unsupported device {x.device}")
    h, i = wg.shape
    if x.shape[-1] != h or wu.shape != (h, i) or wd.shape != (i, h) \
            or sg.shape != (i,) or su.shape != (i,) or sd.shape != (h,):
        raise ValueError("gated_mlp_int8: shapes do not fit")
    xm, out, part = _prepare("gated_mlp_int8", x, (wg, wu, wd), (sg, su, sd),
                             activation)
    if xm.shape[0]:
        lib = _build.load("fused_mlp", _SIGNATURE)
        p = _build.ptr
        err = lib.tsk_gated_mlp_int8(
            p(xm), p(wg), p(sg), p(wu), p(su), p(wd), p(sd), p(part), p(out),
            xm.shape[0], h, i, i // part.shape[0], _ACTS[activation],
            _build.stream_of(x))
        _build.check(err, "gated_mlp_int8")
        gated_mlp_int8.launches += 1
    return out.reshape(*x.shape[:-1], h)


def ffn_int8(x, w1, s1, b1, w2, s2, b2, activation: str = "swish"):
    """The conformer FFN, -> [..., D] f32.  CPU tensors take the plain
    version; CUDA tensors launch csrc/fused_mlp.cu."""
    if x.device.type == "cpu":
        return ffn_int8_plain(x, w1, s1, b1, w2, s2, b2, activation)
    if x.device.type != "cuda":
        raise ValueError(f"ffn_int8: unsupported device {x.device}")
    d, i = w1.shape
    if x.shape[-1] != d or w2.shape != (i, d) or s1.shape != (i,) \
            or b1.shape != (i,) or s2.shape != (d,) or b2.shape != (d,):
        raise ValueError("ffn_int8: shapes do not fit")
    xm, out, part = _prepare("ffn_int8", x, (w1, w2), (s1, b1, s2, b2),
                             activation)
    if xm.shape[0]:
        lib = _build.load("fused_mlp", _SIGNATURE)
        p = _build.ptr
        err = lib.tsk_ffn_int8(
            p(xm), p(w1), p(s1), p(b1), p(w2), p(s2), p(b2), p(part), p(out),
            xm.shape[0], d, i, i // part.shape[0], _ACTS[activation],
            _build.stream_of(x))
        _build.check(err, "ffn_int8")
        ffn_int8.launches += 1
    return out.reshape(*x.shape[:-1], d)


gated_mlp_int8.launches = 0
ffn_int8.launches = 0
