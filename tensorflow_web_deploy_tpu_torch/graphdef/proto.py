"""Minimal protobuf wire-format decoder for frozen TensorFlow ``GraphDef``
files (the port's own copy of the JAX package's ``graphdef/proto.py``: the
same bytes parse into the same nodes, attrs and arrays).

The original project loads frozen ``.pb`` graphs through the TensorFlow
runtime (``GraphDef.ParseFromString`` + ``tf.import_graph_def``). This
module decodes the protobuf *wire format* in pure Python, covering exactly
the subset of message types a frozen inference graph uses: ``GraphDef``,
``NodeDef``, ``AttrValue``, ``TensorProto`` and ``TensorShapeProto``. The
serving runtime therefore imports no TensorFlow; TensorFlow is used only
by tests, as the oracle.

Wire-format background: a protobuf message is a sequence of (tag, value)
pairs; ``tag = (field_number << 3) | wire_type`` with wire types
0 = varint, 1 = fixed64, 2 = length-delimited, 5 = fixed32.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

try:  # bfloat16 numpy dtype (the ml_dtypes package)
    import ml_dtypes

    _BFLOAT16 = np.dtype(ml_dtypes.bfloat16)
except ImportError:  # pragma: no cover
    _BFLOAT16 = np.dtype(np.uint16)  # raw bits fallback

# --------------------------------------------------------------------------
# low-level wire readers
# --------------------------------------------------------------------------

_VARINT = 0
_FIXED64 = 1
_LEN = 2
_FIXED32 = 5


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("malformed varint")


def _to_signed64(v: int) -> int:
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >= (1 << 63) else v


def _fields(buf: bytes):
    """Yield (field_number, wire_type, value) over a message buffer.

    ``value`` is an int for varint/fixed types and a ``memoryview``-sliced
    ``bytes`` for length-delimited fields.
    """
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == _VARINT:
            val, pos = _read_varint(buf, pos)
        elif wire == _LEN:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos : pos + ln]
            pos += ln
        elif wire == _FIXED32:
            val = int.from_bytes(buf[pos : pos + 4], "little")
            pos += 4
        elif wire == _FIXED64:
            val = int.from_bytes(buf[pos : pos + 8], "little")
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _packed_varints(buf: bytes) -> list[int]:
    out = []
    pos = 0
    while pos < len(buf):
        v, pos = _read_varint(buf, pos)
        out.append(_to_signed64(v))
    return out


# --------------------------------------------------------------------------
# tensorflow DataType enum (tensorflow/core/framework/types.proto)
# --------------------------------------------------------------------------

DT_FLOAT = 1
DT_DOUBLE = 2
DT_INT32 = 3
DT_UINT8 = 4
DT_INT16 = 5
DT_INT8 = 6
DT_STRING = 7
DT_COMPLEX64 = 8
DT_INT64 = 9
DT_BOOL = 10
DT_BFLOAT16 = 14
DT_UINT16 = 17
DT_COMPLEX128 = 18
DT_HALF = 19
DT_UINT32 = 22
DT_UINT64 = 23

_NP_DTYPES: dict[int, np.dtype] = {
    DT_FLOAT: np.dtype(np.float32),
    DT_DOUBLE: np.dtype(np.float64),
    DT_INT32: np.dtype(np.int32),
    DT_UINT8: np.dtype(np.uint8),
    DT_INT16: np.dtype(np.int16),
    DT_INT8: np.dtype(np.int8),
    DT_COMPLEX64: np.dtype(np.complex64),
    DT_INT64: np.dtype(np.int64),
    DT_BOOL: np.dtype(np.bool_),
    DT_BFLOAT16: _BFLOAT16,
    DT_UINT16: np.dtype(np.uint16),
    DT_COMPLEX128: np.dtype(np.complex128),
    DT_HALF: np.dtype(np.float16),
    DT_UINT32: np.dtype(np.uint32),
    DT_UINT64: np.dtype(np.uint64),
}


def np_dtype(dt: int) -> np.dtype:
    try:
        return _NP_DTYPES[dt]
    except KeyError:
        raise ValueError(f"unsupported TF DataType enum {dt}") from None


# --------------------------------------------------------------------------
# TensorShapeProto / TensorProto
# --------------------------------------------------------------------------


def _parse_shape(buf: bytes) -> list[int] | None:
    """Return dim sizes, or None for unknown rank."""
    dims: list[int] = []
    unknown = False
    for field, wire, val in _fields(buf):
        if field == 2 and wire == _LEN:  # Dim
            size = 0
            for f2, w2, v2 in _fields(val):
                if f2 == 1 and w2 == _VARINT:
                    size = _to_signed64(v2)
            dims.append(size)
        elif field == 3 and wire == _VARINT:  # unknown_rank
            unknown = bool(val)
    return None if unknown else dims


def _parse_tensor(buf: bytes) -> np.ndarray | list[bytes]:
    """Decode a ``TensorProto`` into a numpy array (or list[bytes] for strings)."""
    dtype_enum = 0
    shape: list[int] = []
    content = b""
    float_vals: list[float] = []
    double_vals: list[float] = []
    int_vals: list[int] = []
    int64_vals: list[int] = []
    bool_vals: list[int] = []
    half_vals: list[int] = []
    string_vals: list[bytes] = []

    for field, wire, val in _fields(buf):
        if field == 1 and wire == _VARINT:
            dtype_enum = val
        elif field == 2 and wire == _LEN:
            shape = _parse_shape(val) or []
        elif field == 4 and wire == _LEN:
            content = val
        elif field == 5:  # float_val
            if wire == _LEN:
                float_vals.extend(np.frombuffer(val, np.float32).tolist())
            else:
                float_vals.append(
                    np.frombuffer(val.to_bytes(4, "little"), np.float32)[0].item()
                )
        elif field == 6:  # double_val
            if wire == _LEN:
                double_vals.extend(np.frombuffer(val, np.float64).tolist())
            else:
                double_vals.append(
                    np.frombuffer(val.to_bytes(8, "little"), np.float64)[0].item()
                )
        elif field == 7:  # int_val
            int_vals.extend(_packed_varints(val) if wire == _LEN else [_to_signed64(val)])
        elif field == 8 and wire == _LEN:  # string_val
            string_vals.append(val)
        elif field == 10:  # int64_val
            int64_vals.extend(_packed_varints(val) if wire == _LEN else [_to_signed64(val)])
        elif field == 11:  # bool_val
            bool_vals.extend(_packed_varints(val) if wire == _LEN else [val])
        elif field == 13:  # half_val / bfloat16 bits (stored as int32 varints)
            half_vals.extend(_packed_varints(val) if wire == _LEN else [val])
        elif field == 16:  # uint32_val
            int_vals.extend(_packed_varints(val) if wire == _LEN else [val])
        elif field == 17:  # uint64_val
            int64_vals.extend(
                [v & ((1 << 64) - 1) for v in _packed_varints(val)] if wire == _LEN else [val]
            )

    if dtype_enum == DT_STRING:
        return string_vals

    dt = np_dtype(dtype_enum)
    n_elems = int(np.prod(shape)) if shape else 1

    if content:
        arr = np.frombuffer(content, dt)
        return arr.reshape(shape)

    if dtype_enum in (DT_HALF, DT_BFLOAT16) and half_vals:
        vals = np.array(half_vals, np.uint16).view(dt)
    elif dtype_enum == DT_FLOAT:
        vals = np.array(float_vals, dt)
    elif dtype_enum == DT_DOUBLE:
        vals = np.array(double_vals, dt)
    elif dtype_enum in (DT_INT64, DT_UINT64):
        vals = np.array(int64_vals, dt)
    elif dtype_enum == DT_BOOL:
        vals = np.array(bool_vals, dt)
    else:
        vals = np.array(int_vals).astype(dt)

    if vals.size == 0:
        return np.zeros(shape, dt)
    if vals.size == 1 and n_elems != 1:
        # TF compresses constant tensors: a single value broadcasts to the shape.
        return np.full(shape, vals[0], dt)
    if vals.size < n_elems:
        # Trailing elements repeat the last explicit value.
        out = np.full(n_elems, vals[-1], dt)
        out[: vals.size] = vals
        return out.reshape(shape)
    return vals.reshape(shape)


# --------------------------------------------------------------------------
# AttrValue
# --------------------------------------------------------------------------


@dataclasses.dataclass
class Attr:
    """A parsed ``AttrValue``: ``kind`` names which oneof member was set."""

    kind: str
    value: Any


def _parse_list_value(buf: bytes) -> Attr:
    out: dict[str, list] = {"s": [], "i": [], "f": [], "b": [], "type": [], "shape": [], "tensor": []}
    for field, wire, val in _fields(buf):
        if field == 2:
            out["s"].append(val)
        elif field == 3:
            out["i"].extend(_packed_varints(val) if wire == _LEN else [_to_signed64(val)])
        elif field == 4:
            if wire == _LEN:
                out["f"].extend(np.frombuffer(val, np.float32).tolist())
            else:
                out["f"].append(np.frombuffer(val.to_bytes(4, "little"), np.float32)[0].item())
        elif field == 5:
            out["b"].extend([bool(v) for v in (_packed_varints(val) if wire == _LEN else [val])])
        elif field == 6:
            out["type"].extend(_packed_varints(val) if wire == _LEN else [val])
        elif field == 7:
            out["shape"].append(_parse_shape(val))
        elif field == 8:
            out["tensor"].append(_parse_tensor(val))
    # Pick the populated member; an empty list attr stays an empty "i" list.
    for k in ("s", "i", "f", "b", "type", "shape", "tensor"):
        if out[k]:
            return Attr("list", out[k])
    return Attr("list", [])


def _parse_attr_value(buf: bytes) -> Attr:
    for field, wire, val in _fields(buf):
        if field == 1 and wire == _LEN:
            return _parse_list_value(val)
        if field == 2 and wire == _LEN:
            return Attr("s", val)
        if field == 3 and wire == _VARINT:
            return Attr("i", _to_signed64(val))
        if field == 4:
            raw = val.to_bytes(4, "little") if isinstance(val, int) else val
            return Attr("f", np.frombuffer(raw, np.float32)[0].item())
        if field == 5 and wire == _VARINT:
            return Attr("b", bool(val))
        if field == 6 and wire == _VARINT:
            return Attr("type", val)
        if field == 7 and wire == _LEN:
            return Attr("shape", _parse_shape(val))
        if field == 8 and wire == _LEN:
            return Attr("tensor", _parse_tensor(val))
        if field == 9 and wire == _LEN:
            return Attr("placeholder", val.decode())
        if field == 10 and wire == _LEN:
            return Attr("func", None)
    return Attr("none", None)


# --------------------------------------------------------------------------
# NodeDef / GraphDef
# --------------------------------------------------------------------------


@dataclasses.dataclass
class NodeDef:
    name: str
    op: str
    inputs: list[str]
    attrs: dict[str, Attr]
    device: str = ""

    def attr(self, key: str, default: Any = None) -> Any:
        a = self.attrs.get(key)
        return default if a is None else a.value


@dataclasses.dataclass
class GraphDef:
    nodes: list[NodeDef]

    @property
    def node_map(self) -> dict[str, NodeDef]:
        return {n.name: n for n in self.nodes}


def _parse_node(buf: bytes) -> NodeDef:
    name = ""
    op = ""
    inputs: list[str] = []
    device = ""
    attrs: dict[str, Attr] = {}
    for field, wire, val in _fields(buf):
        if field == 1 and wire == _LEN:
            name = val.decode()
        elif field == 2 and wire == _LEN:
            op = val.decode()
        elif field == 3 and wire == _LEN:
            inputs.append(val.decode())
        elif field == 4 and wire == _LEN:
            device = val.decode()
        elif field == 5 and wire == _LEN:  # map<string, AttrValue> entry
            key = None
            attr = None
            for f2, w2, v2 in _fields(val):
                if f2 == 1 and w2 == _LEN:
                    key = v2.decode()
                elif f2 == 2 and w2 == _LEN:
                    attr = _parse_attr_value(v2)
            if key is not None and attr is not None:
                attrs[key] = attr
    return NodeDef(name=name, op=op, inputs=inputs, attrs=attrs, device=device)


def parse_graphdef(data: bytes) -> GraphDef:
    """Parse serialized ``GraphDef`` bytes (the content of a frozen ``.pb``)."""
    nodes: list[NodeDef] = []
    for field, wire, val in _fields(data):
        if field == 1 and wire == _LEN:
            nodes.append(_parse_node(val))
        # field 2 (FunctionDefLibrary) and 4 (VersionDef) are irrelevant for
        # frozen inference graphs and are skipped.
    return GraphDef(nodes=nodes)


def load_pb(path: str) -> GraphDef:
    with open(path, "rb") as f:
        return parse_graphdef(f.read())
