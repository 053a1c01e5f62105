"""Minimal ONNX protobuf writer, the mirror of onnx_import's reader (the
port's own copy of the JAX package's frontend/onnx_build.py).

Builds .onnx byte blobs without the `onnx` package: the tests and
chip_smoke.py build their architecture-shaped graphs with it, and a user
can repack a graph with it (e.g. slice a subgraph out of campplus.onnx).
Field numbers follow the ONNX proto schema documented in onnx_import.py.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np

_NP_TO_ONNX = {
    np.dtype(np.float32): 1, np.dtype(np.uint8): 2, np.dtype(np.int8): 3,
    np.dtype(np.int16): 5, np.dtype(np.int32): 6, np.dtype(np.int64): 7,
    np.dtype(np.bool_): 9, np.dtype(np.float16): 10, np.dtype(np.float64): 11,
}


def _varint(v: int) -> bytes:
    if v < 0:
        v += 1 << 64
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(fnum: int, wtype: int) -> bytes:
    return _varint((fnum << 3) | wtype)


def _len_field(fnum: int, payload: bytes) -> bytes:
    return _tag(fnum, 2) + _varint(len(payload)) + payload


def _varint_field(fnum: int, v: int) -> bytes:
    return _tag(fnum, 0) + _varint(v)


def _string_field(fnum: int, s) -> bytes:
    return _len_field(fnum, s if isinstance(s, bytes) else s.encode("utf-8"))


def tensor(name: str, arr: np.ndarray) -> bytes:
    """TensorProto: dims(1, packed) dtype(2) name(8) raw_data(9)."""
    arr = np.asarray(arr, order="C")  # ascontiguousarray would promote 0-d to 1-d
    out = bytearray()
    if arr.ndim:
        dims = b"".join(_varint(d) for d in arr.shape)
        out += _len_field(1, dims)
    out += _varint_field(2, _NP_TO_ONNX[arr.dtype])
    out += _string_field(8, name)
    out += _len_field(9, arr.tobytes())
    return bytes(out)


def _attribute(name: str, value: Any) -> bytes:
    out = bytearray(_string_field(1, name))
    if isinstance(value, bool):
        out += _varint_field(3, int(value)) + _varint_field(20, 2)
    elif isinstance(value, (int, np.integer)):
        out += _varint_field(3, int(value)) + _varint_field(20, 2)
    elif isinstance(value, float):
        out += _tag(2, 5) + struct.pack("<f", value) + _varint_field(20, 1)
    elif isinstance(value, (str, bytes)):
        out += _string_field(4, value) + _varint_field(20, 3)
    elif isinstance(value, np.ndarray):
        out += _len_field(5, tensor("", value)) + _varint_field(20, 4)
    elif isinstance(value, (list, tuple)):
        if all(isinstance(v, (int, np.integer)) for v in value):
            out += _len_field(8, b"".join(_varint(int(v)) for v in value))
            out += _varint_field(20, 7)
        else:
            out += _len_field(7, b"".join(struct.pack("<f", v) for v in value))
            out += _varint_field(20, 6)
    else:
        raise TypeError(f"unsupported attribute {name}={value!r}")
    return bytes(out)


def node(op_type: str, inputs: Sequence[str], outputs: Sequence[str],
         name: str = "", **attrs) -> bytes:
    """NodeProto: input(1) output(2) name(3) op_type(4) attribute(5)."""
    out = bytearray()
    for i in inputs:
        out += _string_field(1, i)
    for o in outputs:
        out += _string_field(2, o)
    out += _string_field(3, name or f"{op_type}_{id(attrs) & 0xffff}")
    out += _string_field(4, op_type)
    for k, v in attrs.items():
        out += _len_field(5, _attribute(k, v))
    return bytes(out)


def graph(nodes: Sequence[bytes], inputs: Sequence[str],
          outputs: Sequence[str],
          initializers: Optional[Mapping[str, np.ndarray]] = None) -> bytes:
    """GraphProto: node(1) initializer(5) input(11) output(12)."""
    out = bytearray()
    for n in nodes:
        out += _len_field(1, n)
    out += _string_field(2, "graph")
    for name, arr in (initializers or {}).items():
        out += _len_field(5, tensor(name, arr))
    for i in inputs:
        out += _len_field(11, _string_field(1, i))
    for o in outputs:
        out += _len_field(12, _string_field(1, o))
    return bytes(out)


def model(graph_bytes: bytes, opset: int = 17) -> bytes:
    """ModelProto: ir_version(1) graph(7) opset_import(8)."""
    out = bytearray()
    out += _varint_field(1, 8)                      # ir_version
    out += _len_field(7, graph_bytes)
    out += _len_field(8, _varint_field(2, opset))   # OperatorSetIdProto.version
    return bytes(out)


def build(nodes: Sequence[bytes], inputs: Sequence[str],
          outputs: Sequence[str],
          initializers: Optional[Mapping[str, np.ndarray]] = None) -> bytes:
    """One-call .onnx blob."""
    return model(graph(nodes, inputs, outputs, initializers))
