"""Execute ONNX graphs with PyTorch on an explicit device (counterpart of
the JAX package's frontend/onnx_exec.py, which runs them as JAX functions).

The reference runs two opaque ONNX graphs through onnxruntime:
`campplus.onnx` / `speaker_embed.onnx` (the CAM++ 192-d x-vector) and
`speech_tokenizer_v1.onnx` (the S3 tokenizer).  Here the graph parsed by
`onnx_import.load_onnx` is interpreted node by node with torch operations,
eagerly, on the function's device (CUDA unless "cpu" is asked for).

Values are torch tensors on that device, or numpy arrays on the host: the
integer and boolean initializers, `Shape`, `Constant`, `ConstantOfShape`
and `Range` results, and what an operation computes from host values only
(run through the same torch operation on the CPU).  So the shape machinery
of exporters (Shape -> Gather -> Concat -> Reshape) stays on the host, and
a reshape or slice target never waits on the device.  Float initializers
are moved to the device once, when the function is built.

ONNX semantics kept where they are easy to get wrong: integer `Div`
truncates toward zero, integer `Mod` takes the divisor's sign (C's fmod
with `fmod=1`), `Reshape` resolves 0 (unless `allowzero`) and -1, `Slice`
clamps ends past the axis (INT64_MAX) and takes negative steps, `Gather`
counts negative indices from the end, `ArgMin` / `ArgMax` return the first
of tied entries (int64), `Cast` from float to int truncates, `Gelu` is the
erf form unless `approximate="tanh"`, `Conv` takes asymmetric pads, groups
and dilations.  The f32 graphs run with TF32 off: the S3 tokenizer's VQ
argmin flips on TF32-scale drift.
"""

from __future__ import annotations

import contextlib
from collections import Counter
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from taste_spokenlm_tpu_torch.device import resolve_device
from taste_spokenlm_tpu_torch.frontend.onnx_import import (_ONNX_DTYPES,
                                                           OnnxGraph,
                                                           OnnxNode,
                                                           load_onnx)

_OPS: Dict[str, Callable] = {}

_TORCH_DTYPES = {
    np.float32: torch.float32, np.uint8: torch.uint8, np.int8: torch.int8,
    np.int16: torch.int16, np.int32: torch.int32, np.int64: torch.int64,
    np.bool_: torch.bool, np.float16: torch.float16, np.float64: torch.float64,
}


def _op(name):
    def deco(fn):
        _OPS[name] = fn
        return fn
    return deco


def _ints(v, default=None):
    if v is None:
        return default
    if isinstance(v, (list, tuple)):
        return [int(x) for x in v]
    return [int(v)]


def _host(x) -> np.ndarray:
    """A value that must be static (shape / axes / pads operands)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _is_host(x) -> bool:
    return not isinstance(x, torch.Tensor)


class _Ctx:
    """What an op needs besides its node and inputs: the device that
    host values move to when they meet a device tensor."""

    def __init__(self, device: torch.device):
        self.device = device

    def t(self, x, like: Optional[torch.Tensor] = None) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x
        a = np.asarray(x)
        dev = like.device if like is not None else self.device
        return torch.from_numpy(np.array(a, copy=True)).to(dev)


def _elementwise(fn):
    """An op over tensors; on host inputs only it runs on the CPU and its
    result stays on the host."""
    def impl(node, v, ctx):
        if all(_is_host(x) for x in v if x is not None):
            cpu = _Ctx(torch.device("cpu"))
            return fn(node, [None if x is None else cpu.t(x) for x in v]
                      ).numpy()
        dev = next(x for x in v if isinstance(x, torch.Tensor))
        return fn(node, [None if x is None else ctx.t(x, dev) for x in v])
    return impl


def _register_elementwise(name, fn):
    _OPS[name] = _elementwise(fn)


# ---------------------------------------------------------------------------
# elementwise / unary
# ---------------------------------------------------------------------------

_UNARY = {
    "Relu": torch.relu, "Sigmoid": torch.sigmoid, "Tanh": torch.tanh,
    "Exp": torch.exp, "Log": torch.log, "Sqrt": torch.sqrt,
    "Neg": torch.neg, "Abs": torch.abs, "Floor": torch.floor,
    "Ceil": torch.ceil, "Round": torch.round, "Erf": torch.erf,
    "Sign": torch.sign, "Reciprocal": torch.reciprocal,
    "Not": torch.logical_not, "Softplus": F.softplus,
    "Identity": lambda x: x, "Sin": torch.sin, "Cos": torch.cos,
}
for _name, _fn in _UNARY.items():
    _register_elementwise(_name, (lambda f: lambda node, v: f(v[0]))(_fn))


def _div(a, b):
    if a.is_floating_point() or b.is_floating_point():
        return torch.div(a, b)
    return torch.div(a, b, rounding_mode="trunc")


_BINARY = {
    "Add": torch.add, "Sub": torch.sub, "Mul": torch.mul, "Div": _div,
    "Pow": torch.pow, "Equal": torch.eq, "Less": torch.lt,
    "LessOrEqual": torch.le, "Greater": torch.gt,
    "GreaterOrEqual": torch.ge, "And": torch.logical_and,
    "Or": torch.logical_or,
}
for _name, _fn in _BINARY.items():
    _register_elementwise(_name, (lambda f: lambda node, v: f(v[0], v[1]))(_fn))


@_op("Max")
@_elementwise
def _max(node, v):
    out = v[0]
    for x in v[1:]:
        out = torch.maximum(out, x)
    return out


@_op("Min")
@_elementwise
def _min(node, v):
    out = v[0]
    for x in v[1:]:
        out = torch.minimum(out, x)
    return out


@_op("Mod")
@_elementwise
def _mod(node, v):
    if node.attributes.get("fmod", 0):
        return torch.fmod(v[0], v[1])
    return torch.remainder(v[0], v[1])


@_op("LeakyRelu")
@_elementwise
def _leaky_relu(node, v):
    return F.leaky_relu(v[0], node.attributes.get("alpha", 0.01))


@_op("Elu")
@_elementwise
def _elu(node, v):
    return F.elu(v[0], node.attributes.get("alpha", 1.0))


@_op("HardSigmoid")
@_elementwise
def _hard_sigmoid(node, v):
    a = node.attributes.get("alpha", 0.2)
    b = node.attributes.get("beta", 0.5)
    return torch.clamp(a * v[0] + b, 0.0, 1.0)


@_op("Gelu")
@_elementwise
def _gelu(node, v):
    tanh = node.attributes.get("approximate", b"none") == b"tanh"
    return F.gelu(v[0], approximate="tanh" if tanh else "none")


@_op("Clip")
@_elementwise
def _clip(node, v):
    lo = v[1] if len(v) > 1 and v[1] is not None else node.attributes.get("min")
    hi = v[2] if len(v) > 2 and v[2] is not None else node.attributes.get("max")
    out = v[0]
    if lo is not None:
        out = torch.maximum(out, torch.as_tensor(lo, dtype=out.dtype,
                                                 device=out.device))
    if hi is not None:
        out = torch.minimum(out, torch.as_tensor(hi, dtype=out.dtype,
                                                 device=out.device))
    return out


@_op("Where")
@_elementwise
def _where(node, v):
    return torch.where(v[0].bool(), v[1], v[2])


@_op("Cast")
@_elementwise
def _cast(node, v):
    return v[0].to(_TORCH_DTYPES[_ONNX_DTYPES[int(node.attributes["to"])]])


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------


def _reduce(fn):
    @_elementwise
    def impl(node, v):
        axes = _ints(node.attributes.get("axes"))
        if axes is None and len(v) > 1 and v[1] is not None:  # opset >= 18
            axes = [int(a) for a in _host(v[1]).reshape(-1)]
        keep = bool(node.attributes.get("keepdims", 1))
        x = v[0]
        dims = tuple(axes) if axes is not None else tuple(range(x.ndim))
        return fn(x, dims, keep)
    return impl


def _amax(x, dims, keep):
    return torch.amax(x, dim=dims, keepdim=keep)


def _amin(x, dims, keep):
    return torch.amin(x, dim=dims, keepdim=keep)


def _prod(x, dims, keep):
    for d in sorted((d % x.ndim for d in dims), reverse=True):
        x = torch.prod(x, dim=d, keepdim=keep)
    return x


_OPS["ReduceMean"] = _reduce(lambda x, d, k: torch.mean(x, dim=d, keepdim=k))
_OPS["ReduceSum"] = _reduce(lambda x, d, k: torch.sum(x, dim=d, keepdim=k))
_OPS["ReduceMax"] = _reduce(_amax)
_OPS["ReduceMin"] = _reduce(_amin)
_OPS["ReduceProd"] = _reduce(_prod)
_OPS["ReduceL2"] = _reduce(
    lambda x, d, k: torch.sqrt(torch.sum(x * x, dim=d, keepdim=k)))


def _arg(fn):
    @_elementwise
    def impl(node, v):
        axis = int(node.attributes.get("axis", 0))
        keep = bool(node.attributes.get("keepdims", 1))
        x = v[0]
        if node.attributes.get("select_last_index", 0):
            n = x.shape[axis]
            idx = fn(torch.flip(x, (axis,)), dim=axis, keepdim=keep)
            return n - 1 - idx
        return fn(x, dim=axis, keepdim=keep)
    return impl


# torch's argmax / argmin return the first of tied entries (documented)
_OPS["ArgMax"] = _arg(torch.argmax)
_OPS["ArgMin"] = _arg(torch.argmin)


@_op("TopK")
def _topk(node, v, ctx):
    k = int(_host(v[1]).reshape(()))
    axis = int(node.attributes.get("axis", -1))
    largest = bool(node.attributes.get("largest", 1))
    x = ctx.t(v[0])
    vals, idx = torch.topk(x, k, dim=axis, largest=largest, sorted=True)
    return [vals, idx]


# ---------------------------------------------------------------------------
# tensor manipulation
# ---------------------------------------------------------------------------


@_op("Shape")
def _shape(node, v, ctx):
    shape = np.asarray(tuple(v[0].shape), np.int64)
    start = int(node.attributes.get("start", 0))
    end = node.attributes.get("end")
    return shape[start:(int(end) if end is not None else None)]


@_op("Size")
def _size(node, v, ctx):
    return np.asarray(int(np.prod(tuple(v[0].shape), dtype=np.int64)),
                      np.int64)


def _reshape_target(x, target, allowzero):
    if not allowzero:
        target = [x.shape[i] if s == 0 else s for i, s in enumerate(target)]
    return target


@_op("Reshape")
def _reshape(node, v, ctx):
    target = _reshape_target(v[0], [int(s) for s in _host(v[1]).reshape(-1)],
                             node.attributes.get("allowzero", 0))
    if _is_host(v[0]):
        return np.reshape(v[0], target)
    return torch.reshape(v[0], target)


@_op("Transpose")
def _transpose(node, v, ctx):
    perm = _ints(node.attributes.get("perm"))
    if perm is None:
        perm = list(range(v[0].ndim))[::-1]
    if _is_host(v[0]):
        return np.transpose(v[0], perm)
    return v[0].permute(*perm)


@_op("Concat")
def _concat(node, v, ctx):
    axis = int(node.attributes["axis"])
    if all(_is_host(x) for x in v):
        return np.concatenate([np.asarray(x) for x in v], axis=axis)
    dev = next(x for x in v if isinstance(x, torch.Tensor))
    return torch.cat([ctx.t(x, dev) for x in v], dim=axis)


@_op("Split")
def _split(node, v, ctx):
    axis = int(node.attributes.get("axis", 0))
    if len(v) > 1 and v[1] is not None:
        sizes = [int(s) for s in _host(v[1]).reshape(-1)]
    elif "split" in node.attributes:
        sizes = _ints(node.attributes["split"])
    else:
        n = int(node.attributes.get("num_outputs", len(node.outputs)))
        d = v[0].shape[axis]
        chunk = -(-d // n)
        sizes = [chunk] * (d // chunk) + ([d % chunk] if d % chunk else [])
    if _is_host(v[0]):
        return np.split(v[0], np.cumsum(sizes)[:-1].tolist(), axis=axis)
    return list(torch.split(v[0], sizes, dim=axis))


def _slice_params(node, v):
    if len(v) > 1:  # opset >= 10: operands
        starts = [int(s) for s in _host(v[1]).reshape(-1)]
        ends = [int(s) for s in _host(v[2]).reshape(-1)]
        axes = ([int(s) for s in _host(v[3]).reshape(-1)]
                if len(v) > 3 and v[3] is not None else list(range(len(starts))))
        steps = ([int(s) for s in _host(v[4]).reshape(-1)]
                 if len(v) > 4 and v[4] is not None else [1] * len(starts))
    else:  # opset 1: attributes
        starts = _ints(node.attributes["starts"])
        ends = _ints(node.attributes["ends"])
        axes = _ints(node.attributes.get("axes"), list(range(len(starts))))
        steps = [1] * len(starts)
    return starts, ends, axes, steps


def _slice_range(st: int, en: int, sp: int, dim: int) -> range:
    """ONNX Slice's clamping: negative starts / ends count from the end,
    both clamp to [0, dim] (a positive step) or [-1, dim - 1] (a negative
    one, where -1 means "through element 0")."""
    if st < 0:
        st += dim
    if en < 0:
        en += dim
    if sp > 0:
        return range(min(max(st, 0), dim), min(max(en, 0), dim), sp)
    return range(min(max(st, -1), dim - 1), min(max(en, -1), dim - 1), sp)


@_op("Slice")
def _slice(node, v, ctx):
    x = v[0]
    for st, en, ax, sp in zip(*_slice_params(node, v)):
        ax = ax % x.ndim
        r = _slice_range(st, en, sp, x.shape[ax])
        if _is_host(x):
            x = np.take(x, np.asarray(r, np.int64), axis=ax)
        elif sp > 0:
            x = x.narrow(ax, r.start, max(len(range(r.start, r.stop)), 0)) \
                if sp == 1 else x[(slice(None),) * ax
                                  + (slice(r.start, r.stop, sp),)]
        else:
            x = torch.index_select(x, ax, torch.as_tensor(
                list(r), dtype=torch.long, device=x.device))
    return x


@_op("Gather")
def _gather(node, v, ctx):
    axis = int(node.attributes.get("axis", 0))
    if _is_host(v[0]) and _is_host(v[1]):
        idx = np.asarray(v[1]).astype(np.int64)
        return np.take(v[0], np.where(idx < 0, idx + v[0].shape[axis], idx),
                       axis=axis)
    x = ctx.t(v[0])
    idx = ctx.t(v[1], x).long()
    idx = torch.where(idx < 0, idx + x.shape[axis], idx)
    axis = axis % x.ndim
    out = torch.index_select(x, axis, idx.reshape(-1))
    return out.reshape(tuple(x.shape[:axis]) + tuple(idx.shape)
                       + tuple(x.shape[axis + 1:]))


@_op("GatherElements")
def _gather_elements(node, v, ctx):
    axis = int(node.attributes.get("axis", 0))
    x = ctx.t(v[0])
    idx = ctx.t(v[1], x).long()
    idx = torch.where(idx < 0, idx + x.shape[axis], idx)
    return torch.gather(x, axis, idx)


@_op("Unsqueeze")
def _unsqueeze(node, v, ctx):
    axes = _ints(node.attributes.get("axes"))
    if axes is None:
        axes = [int(a) for a in _host(v[1]).reshape(-1)]
    out = v[0]
    rank = out.ndim + len(axes)
    for ax in sorted(a % rank for a in axes):
        out = np.expand_dims(out, ax) if _is_host(out) else out.unsqueeze(ax)
    return out


@_op("Squeeze")
def _squeeze(node, v, ctx):
    axes = _ints(node.attributes.get("axes"))
    if axes is None and len(v) > 1 and v[1] is not None:
        axes = [int(a) for a in _host(v[1]).reshape(-1)]
    if axes is None:
        axes = [i for i, s in enumerate(v[0].shape) if s == 1]
    out = v[0]
    for ax in sorted((a % out.ndim for a in axes), reverse=True):
        out = np.squeeze(out, ax) if _is_host(out) else out.squeeze(ax)
    return out


@_op("Flatten")
def _flatten(node, v, ctx):
    axis = int(node.attributes.get("axis", 1))
    lead = int(np.prod(tuple(v[0].shape[:axis]), dtype=np.int64)) if axis else 1
    if _is_host(v[0]):
        return np.reshape(v[0], (lead, -1))
    return torch.reshape(v[0], (lead, -1))


@_op("Expand")
def _expand(node, v, ctx):
    target = tuple(int(s) for s in _host(v[1]).reshape(-1))
    shape = np.broadcast_shapes(tuple(v[0].shape), target)
    if _is_host(v[0]):
        return np.broadcast_to(v[0], shape)
    return v[0].expand(shape)


@_op("Tile")
def _tile(node, v, ctx):
    reps = [int(s) for s in _host(v[1]).reshape(-1)]
    if _is_host(v[0]):
        return np.tile(v[0], reps)
    return v[0].repeat(*reps)


@_op("Pad")
def _pad(node, v, ctx):
    mode = node.attributes.get("mode", b"constant")
    mode = mode.decode() if isinstance(mode, bytes) else "constant"
    if len(v) > 1 and v[1] is not None:
        pads = [int(p) for p in _host(v[1]).reshape(-1)]
    else:
        pads = _ints(node.attributes["pads"])
    const = 0.0
    if len(v) > 2 and v[2] is not None:
        const = float(_host(v[2]).reshape(()))
    x = ctx.t(v[0])
    n = x.ndim
    if mode == "constant":
        flat = []
        for i in reversed(range(n)):
            flat += [pads[i], pads[i + n]]
        return F.pad(x, flat, value=const)
    # reflect / edge: gather along each padded axis, the indices from numpy
    for i in range(n):
        if pads[i] or pads[i + n]:
            idx = np.pad(np.arange(x.shape[i]), (pads[i], pads[i + n]),
                         mode={"reflect": "reflect", "edge": "edge"}[mode])
            x = torch.index_select(x, i, torch.from_numpy(idx).to(x.device))
    return x


@_op("Constant")
def _constant(node, v, ctx):
    for key in ("value", "value_float", "value_int", "value_floats",
                "value_ints"):
        if key in node.attributes:
            a = node.attributes[key]
            if isinstance(a, tuple) and a[0] == "tensor":
                return np.asarray(a[1])
            return np.asarray(a)
    raise ValueError(f"Constant node without value: {node.name}")


@_op("ConstantOfShape")
def _constant_of_shape(node, v, ctx):
    shape = tuple(int(s) for s in _host(v[0]).reshape(-1))
    a = node.attributes.get("value")
    fill = np.asarray(a[1]) if isinstance(a, tuple) else np.zeros(1, np.float32)
    return np.full(shape, fill.reshape(-1)[0], fill.dtype)


@_op("Range")
def _range(node, v, ctx):
    start, limit, delta = (_host(x).reshape(()) for x in v)
    return np.arange(start, limit, delta)


@_op("Einsum")
def _einsum(node, v, ctx):
    dev = next((x for x in v if isinstance(x, torch.Tensor)), None)
    return torch.einsum(node.attributes["equation"].decode(),
                        *[ctx.t(x, dev) for x in v])


@_op("CumSum")
def _cumsum(node, v, ctx):
    return torch.cumsum(ctx.t(v[0]), dim=int(_host(v[1]).reshape(())))


# ---------------------------------------------------------------------------
# neural network ops
# ---------------------------------------------------------------------------


@_op("MatMul")
@_elementwise
def _matmul(node, v):
    return torch.matmul(v[0], v[1])


@_op("Gemm")
@_elementwise
def _gemm(node, v):
    a, b = v[0], v[1]
    if node.attributes.get("transA", 0):
        a = a.T
    if node.attributes.get("transB", 0):
        b = b.T
    out = node.attributes.get("alpha", 1.0) * (a @ b)
    if len(v) > 2 and v[2] is not None:
        out = out + node.attributes.get("beta", 1.0) * v[2]
    return out


@_op("Softmax")
@_elementwise
def _softmax(node, v):
    return torch.softmax(v[0], dim=int(node.attributes.get("axis", -1)))


@_op("LogSoftmax")
@_elementwise
def _log_softmax(node, v):
    return torch.log_softmax(v[0], dim=int(node.attributes.get("axis", -1)))


def _conv_pads(node, x, w, strides, dilations):
    """ONNX pads [b0, b1, ..., e0, e1, ...] (or auto_pad) -> [(b, e), ...]."""
    spatial = x.ndim - 2
    auto = node.attributes.get("auto_pad", b"NOTSET")
    if isinstance(auto, bytes):
        auto = auto.decode()
    if auto in ("SAME_UPPER", "SAME_LOWER"):
        pads = []
        for i in range(spatial):
            eff_k = (w.shape[2 + i] - 1) * dilations[i] + 1
            out = -(-x.shape[2 + i] // strides[i])
            total = max(0, (out - 1) * strides[i] + eff_k - x.shape[2 + i])
            half = total // 2
            pads.append((half, total - half) if auto == "SAME_UPPER"
                        else (total - half, half))
        return pads
    p = _ints(node.attributes.get("pads"), [0] * (2 * spatial))
    return [(p[i], p[i + spatial]) for i in range(spatial)]


def _torch_pad(pads):
    """[(b, e) per spatial axis] -> F.pad's last-axis-first list."""
    flat = []
    for b, e in reversed(pads):
        flat += [b, e]
    return flat


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d, 3: F.conv_transpose3d}


@_op("Conv")
@_elementwise
def _conv(node, v):
    x, w = v[0], v[1]
    spatial = x.ndim - 2
    strides = _ints(node.attributes.get("strides"), [1] * spatial)
    dilations = _ints(node.attributes.get("dilations"), [1] * spatial)
    groups = int(node.attributes.get("group", 1))
    pads = _conv_pads(node, x, w, strides, dilations)
    if any(pads[i][0] != pads[i][1] for i in range(spatial)):
        x, padding = F.pad(x, _torch_pad(pads)), 0
    else:
        padding = [b for b, _ in pads]
    bias = v[2] if len(v) > 2 else None
    return _CONV[spatial](x, w, bias, stride=strides, padding=padding,
                          dilation=dilations, groups=groups)


@_op("ConvTranspose")
@_elementwise
def _conv_transpose(node, v):
    x, w = v[0], v[1]  # w: [Cin, Cout/groups, *K]
    spatial = x.ndim - 2
    strides = _ints(node.attributes.get("strides"), [1] * spatial)
    dilations = _ints(node.attributes.get("dilations"), [1] * spatial)
    groups = int(node.attributes.get("group", 1))
    p = _ints(node.attributes.get("pads"), [0] * (2 * spatial))
    out_pad = _ints(node.attributes.get("output_padding"), [0] * spatial)
    # the full transposed conv, then output_padding zeros appended and the
    # pads cropped: begin p[i], end p[i + spatial]
    out = _CONV_T[spatial](x, w, None, stride=strides, groups=groups,
                           dilation=dilations)
    out = F.pad(out, _torch_pad([(0, o) for o in out_pad]))
    for i in range(spatial):
        n = out.shape[2 + i]
        out = out.narrow(2 + i, p[i], n - p[i] - p[i + spatial])
    if len(v) > 2 and v[2] is not None:
        out = out + v[2].reshape((1, -1) + (1,) * spatial)
    return out


@_op("BatchNormalization")
@_elementwise
def _batch_norm(node, v):
    x, scale, bias, mean, var = v[:5]
    eps = node.attributes.get("epsilon", 1e-5)
    shape = (1, -1) + (1,) * (x.ndim - 2)
    inv = scale.reshape(shape) / torch.sqrt(var.reshape(shape) + eps)
    return x * inv + (bias.reshape(shape) - mean.reshape(shape) * inv)


@_op("LayerNormalization")
@_elementwise
def _layer_norm(node, v):
    axis = int(node.attributes.get("axis", -1))
    eps = node.attributes.get("epsilon", 1e-5)
    dims = tuple(range(axis % v[0].ndim, v[0].ndim))
    mean = torch.mean(v[0], dim=dims, keepdim=True)
    var = torch.mean(torch.square(v[0] - mean), dim=dims, keepdim=True)
    out = (v[0] - mean) / torch.sqrt(var + eps)
    out = out * v[1]
    if len(v) > 2 and v[2] is not None:
        out = out + v[2]
    return out


@_op("InstanceNormalization")
@_elementwise
def _instance_norm(node, v):
    eps = node.attributes.get("epsilon", 1e-5)
    dims = tuple(range(2, v[0].ndim))
    mean = torch.mean(v[0], dim=dims, keepdim=True)
    var = torch.mean(torch.square(v[0] - mean), dim=dims, keepdim=True)
    shape = (1, -1) + (1,) * (v[0].ndim - 2)
    return (v[0] - mean) / torch.sqrt(var + eps) * v[1].reshape(shape) \
        + v[2].reshape(shape)


_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOL = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}


def _pool_geometry(node, x):
    spatial = x.ndim - 2
    kernel = _ints(node.attributes["kernel_shape"])
    strides = _ints(node.attributes.get("strides"), [1] * spatial)
    p = _ints(node.attributes.get("pads"), [0] * (2 * spatial))
    return spatial, kernel, strides, [(p[i], p[i + spatial])
                                      for i in range(spatial)]


@_op("MaxPool")
@_elementwise
def _max_pool(node, v):
    x = v[0]
    spatial, kernel, strides, pads = _pool_geometry(node, x)
    x = F.pad(x, _torch_pad(pads), value=-float("inf"))
    return _MAX_POOL[spatial](x, kernel, strides)


@_op("AveragePool")
@_elementwise
def _avg_pool(node, v):
    """Sums over each window of the zero-padded input over the count of
    its entries: every entry (count_include_pad) or only the input's."""
    x = v[0]
    spatial, kernel, strides, pads = _pool_geometry(node, x)
    k = float(np.prod(kernel))
    sums = _AVG_POOL[spatial](F.pad(x, _torch_pad(pads)), kernel, strides) * k
    if node.attributes.get("count_include_pad", 0):
        return sums / k
    ones = F.pad(torch.ones_like(x[:1, :1]), _torch_pad(pads))
    return sums / (_AVG_POOL[spatial](ones, kernel, strides) * k)


@_op("GlobalAveragePool")
@_elementwise
def _global_avg_pool(node, v):
    return torch.mean(v[0], dim=tuple(range(2, v[0].ndim)), keepdim=True)


@_op("GlobalMaxPool")
@_elementwise
def _global_max_pool(node, v):
    return torch.amax(v[0], dim=tuple(range(2, v[0].ndim)), keepdim=True)


# ---------------------------------------------------------------------------
# the executor
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _no_tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


class OnnxTorchFunction:
    """A parsed ONNX graph as a callable on `device` (None: CUDA, which must
    be present; "cpu" for the plain CPU run).

    >>> fn = OnnxTorchFunction.from_file("campplus.onnx", device="cuda")
    >>> emb = fn(fbank)                  # a tensor on the device

    Positional args map to the graph's non-initializer inputs in order,
    keyword args by input name; float numpy arguments move to the device,
    integer ones stay on the host.  Returns one value or a list in
    graph-output order: tensors on the device, or numpy arrays for outputs
    computed on the host only."""

    def __init__(self, graph: OnnxGraph,
                 device: Optional[Union[str, torch.device]] = None):
        self.graph = graph
        self.device = resolve_device(device)
        self._ctx = _Ctx(self.device)
        self.weights: Dict[str, Any] = {
            k: self._place(w) for k, w in graph.initializers.items()}
        self.input_names = [n for n in graph.inputs if n not in self.weights]

    @classmethod
    def from_file(cls, path_or_bytes, device=None) -> "OnnxTorchFunction":
        return cls(load_onnx(path_or_bytes), device=device)

    def _place(self, x):
        if isinstance(x, torch.Tensor):
            return x.to(self.device)
        a = np.asarray(x)
        if np.issubdtype(a.dtype, np.floating):
            return self._ctx.t(a)
        return a

    @torch.no_grad()
    def __call__(self, *args, **kwargs):
        values: Dict[str, Any] = dict(self.weights)
        for name, arg in zip(self.input_names, args):
            values[name] = self._place(arg)
        for name, arg in kwargs.items():
            values[name] = self._place(arg)
        missing = [n for n in self.input_names if n not in values]
        if missing:
            raise ValueError(f"missing graph inputs: {missing}")

        pending: List[OnnxNode] = list(self.graph.nodes)
        with _no_tf32():
            while pending:
                progressed = False
                rest = []
                for node in pending:
                    if all((not i) or i in values for i in node.inputs):
                        self._run_node(node, values)
                        progressed = True
                    else:
                        rest.append(node)
                if not progressed:
                    unmet = {i for n in rest for i in n.inputs
                             if i and i not in values}
                    raise ValueError(f"graph is not resolvable; unmet: {unmet}")
                pending = rest

        outs = [values[o] for o in self.graph.outputs]
        return outs[0] if len(outs) == 1 else outs

    def _run_node(self, node: OnnxNode, values: Dict[str, Any]):
        fn = _OPS.get(node.op_type)
        if fn is None:
            raise NotImplementedError(
                f"ONNX op '{node.op_type}' (node '{node.name}') is not "
                f"supported; supported: {sorted(_OPS)}")
        ins = [values[i] if i else None for i in node.inputs]
        out = fn(node, ins, self._ctx)
        if isinstance(out, (list, tuple)):
            for name, val in zip(node.outputs, out):
                values[name] = val
        else:
            values[node.outputs[0]] = out


def supported_ops() -> List[str]:
    return sorted(_OPS)


def audit_ops(graph_or_blob) -> Dict[str, Any]:
    """Inventory a graph's ops before running it: whether
    `OnnxTorchFunction` can run a freshly downloaded campplus.onnx /
    speech_tokenizer_v1.onnx, instead of a NotImplementedError mid-graph.
    Accepts an OnnxGraph, .onnx bytes, or a path.

    Returns {"op_counts": {op: n}, "unsupported": [op...], "ok": bool,
    "num_nodes": int, "num_initializers": int}."""
    g = (graph_or_blob if isinstance(graph_or_blob, OnnxGraph)
         else load_onnx(graph_or_blob))
    counts = Counter(n.op_type for n in g.nodes)
    unsupported = sorted(set(counts) - set(_OPS))
    return {
        "op_counts": dict(sorted(counts.items())),
        "unsupported": unsupported,
        "ok": not unsupported,
        "num_nodes": len(g.nodes),
        "num_initializers": len(g.initializers),
    }
