"""Minimal ONNX reader: weights and graph structure without the onnx
package (the port's own copy of the JAX package's frontend/onnx_import.py).

The reference runs two opaque ONNX graphs through onnxruntime:
`campplus.onnx` / `speaker_embed.onnx` (the CAM++ 192-d x-vector from an
80-bin fbank) and `speech_tokenizer_v1.onnx` (the S3 supervised tokenizer,
128-mel -> 4096-way ids at 50 Hz).  This module parses the ONNX protobuf
wire format directly and yields the initializer tensors and the node
topology; frontend/onnx_exec.py runs them with PyTorch.

ONNX wire format essentials (protobuf encoding):
  ModelProto: field 7 = GraphProto
  GraphProto: field 1 = NodeProto*, field 5 = TensorProto* (initializer),
              field 11/12 = ValueInfoProto* (inputs/outputs)
  NodeProto:  1=input*, 2=output*, 3=name, 4=op_type, 5=attribute*
  TensorProto: 1=dims*, 2=data_type, 8=name, 9=raw_data,
               4=float_data*, 7=int64_data*
  AttributeProto: 1=name, 20=type, 2=f, 3=i, 4=s, 7=floats*, 8=ints*
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np

_WIRE_VARINT, _WIRE_I64, _WIRE_LEN, _WIRE_I32 = 0, 1, 2, 5


def _read_varint(buf: memoryview, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _fields(buf: memoryview) -> Iterator[Tuple[int, int, Any]]:
    """Yield (field_number, wire_type, value) over a protobuf message."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        fnum, wtype = tag >> 3, tag & 7
        if wtype == _WIRE_VARINT:
            val, pos = _read_varint(buf, pos)
        elif wtype == _WIRE_I64:
            val = bytes(buf[pos:pos + 8])
            pos += 8
        elif wtype == _WIRE_LEN:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wtype == _WIRE_I32:
            val = bytes(buf[pos:pos + 4])
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wtype}")
        yield fnum, wtype, val


_ONNX_DTYPES = {
    1: np.float32, 2: np.uint8, 3: np.int8, 5: np.int16, 6: np.int32,
    7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64,
}


def _parse_tensor(buf: memoryview) -> Tuple[str, np.ndarray]:
    dims: List[int] = []
    dtype = 1
    name = ""
    raw = None
    floats: List[float] = []
    int64s: List[int] = []
    for fnum, wtype, val in _fields(buf):
        if fnum == 1 and wtype == _WIRE_VARINT:
            dims.append(val)
        elif fnum == 1 and wtype == _WIRE_LEN:  # packed dims
            p = 0
            while p < len(val):
                v, p = _read_varint(val, p)
                dims.append(v)
        elif fnum == 2:
            dtype = val
        elif fnum == 8:
            name = bytes(val).decode("utf-8")
        elif fnum == 9:
            raw = bytes(val)
        elif fnum == 4:
            if wtype == _WIRE_LEN:  # packed floats
                floats.extend(struct.unpack(f"<{len(val)//4}f", bytes(val)))
            else:
                floats.append(struct.unpack("<f", val)[0])
        elif fnum == 7:
            if wtype == _WIRE_LEN:
                p = 0
                while p < len(val):
                    v, p = _read_varint(val, p)
                    int64s.append(_s64(v))
            else:
                int64s.append(_s64(val))
    np_dtype = _ONNX_DTYPES.get(dtype, np.float32)
    if raw is not None:
        arr = np.frombuffer(raw, dtype=np_dtype)
    elif floats:
        arr = np.asarray(floats, np.float32)
    elif int64s:
        arr = np.asarray(int64s, np.int64)
    else:
        arr = np.zeros(0, np_dtype)
    # empty dims with one element = a 0-d scalar tensor per the ONNX spec
    return name, arr.reshape(dims) if (dims or arr.size == 1) else arr


@dataclass
class OnnxNode:
    op_type: str
    name: str
    inputs: List[str]
    outputs: List[str]
    attributes: Dict[str, Any]


def _s64(v: int) -> int:
    """Sign-correct a varint-decoded int64 (negative axes are common)."""
    return v - (1 << 64) if v >= (1 << 63) else v


def _parse_attribute(buf: memoryview) -> Tuple[str, Any]:
    name = ""
    out: Any = None
    ints: List[int] = []
    floats: List[float] = []
    for fnum, wtype, val in _fields(buf):
        if fnum == 1:
            name = bytes(val).decode("utf-8")
        elif fnum == 2:
            out = struct.unpack("<f", val)[0]
        elif fnum == 3:
            out = _s64(val) if isinstance(val, int) else val
        elif fnum == 4:
            out = bytes(val)
        elif fnum == 7:
            if wtype == _WIRE_LEN:
                floats.extend(struct.unpack(f"<{len(val)//4}f", bytes(val)))
            else:
                floats.append(struct.unpack("<f", val)[0])
        elif fnum == 8:
            if wtype == _WIRE_LEN:
                p = 0
                while p < len(val):
                    v, p = _read_varint(val, p)
                    ints.append(_s64(v))
            else:
                ints.append(_s64(val))
        elif fnum == 5 and isinstance(val, memoryview):
            out = ("tensor", _parse_tensor(val)[1])
    if ints:
        out = ints
    elif floats and out is None:
        out = floats
    return name, out


def _parse_node(buf: memoryview) -> OnnxNode:
    node = OnnxNode("", "", [], [], {})
    for fnum, wtype, val in _fields(buf):
        if fnum == 1:
            node.inputs.append(bytes(val).decode("utf-8"))
        elif fnum == 2:
            node.outputs.append(bytes(val).decode("utf-8"))
        elif fnum == 3:
            node.name = bytes(val).decode("utf-8")
        elif fnum == 4:
            node.op_type = bytes(val).decode("utf-8")
        elif fnum == 5:
            k, v = _parse_attribute(val)
            node.attributes[k] = v
    return node


@dataclass
class OnnxGraph:
    nodes: List[OnnxNode] = field(default_factory=list)
    initializers: Dict[str, np.ndarray] = field(default_factory=dict)
    inputs: List[str] = field(default_factory=list)
    outputs: List[str] = field(default_factory=list)


def _parse_graph(buf: memoryview) -> OnnxGraph:
    g = OnnxGraph()
    for fnum, wtype, val in _fields(buf):
        if fnum == 1:
            g.nodes.append(_parse_node(val))
        elif fnum == 5:
            name, arr = _parse_tensor(val)
            g.initializers[name] = arr
        elif fnum in (11, 12):
            # ValueInfoProto: field 1 = name
            for f2, _, v2 in _fields(val):
                if f2 == 1:
                    (g.inputs if fnum == 11 else g.outputs).append(
                        bytes(v2).decode("utf-8"))
                    break
    return g


def load_onnx(path_or_bytes) -> OnnxGraph:
    """Parse an .onnx file -> OnnxGraph (nodes + weight initializers)."""
    if isinstance(path_or_bytes, (bytes, bytearray, memoryview)):
        data = memoryview(bytes(path_or_bytes))
    else:
        with open(path_or_bytes, "rb") as f:
            data = memoryview(f.read())
    for fnum, wtype, val in _fields(data):
        if fnum == 7 and wtype == _WIRE_LEN:  # ModelProto.graph
            return _parse_graph(val)
    raise ValueError("no GraphProto found (not an ONNX model?)")
