#!/usr/bin/env python
"""Write frozen ``.pb`` graphs and label files into ``artifacts/`` with no
TensorFlow (the port's counterpart of the repo's ``tools/make_artifacts.py``,
which freezes ``tf.keras.applications`` models).

The card's machine has no TensorFlow and the repo holds no ``.pb``, so this
tool serializes the frozen ``GraphDef`` itself: a small protobuf writer
(varints, length-delimited fields, ``TensorProto`` with ``tensor_content``,
``AttrValue``) and an emitter for the zoo's Inception-v3 and MobileNetV2 at
any width and input size. The graphs carry the op pattern that freezing a
Keras model gives (TF 2.21, Keras 3):

- convs without a bias, their kernels behind ``ReadVariableOp`` identities
  of consts named ``…/ReadVariableOp/resource``;
- each BN as ``AddV2(var, eps) → Rsqrt → Mul(·, gamma)``, then ``Mul`` of
  the data, ``Mul`` of the mean, ``Sub`` from beta and ``AddV2`` (Inception
  reshapes the statistics to ``[1, 1, 1, C]`` first, as Keras does there);
- ``Relu``/``Relu6``; MobileNetV2's stride-2 depthwise convs as ``Pad``
  followed by a VALID conv; ``ConcatV2``, the pools, ``Mean``, ``MatMul``,
  ``BiasAdd`` and ``Softmax``;
- a dynamic batch dimension, the ``input`` placeholder, a trailing
  ``Identity`` and the ``NoOp`` of the variable reads.

The weights are the zoo's seeded init (``models/adapter.py::
init_variables``) unless given, and :func:`make_graph` returns them in the
zoo's flat layout, so ``native:<name>`` with the same seed (or those
params) serves the same network beside the graph. The zoo's Inception-v3
average pools count the padding (flax's rule) where TF's SAME ``AvgPool``
divides by the valid taps, so each is followed by a ``Mul`` with the
constant map count/9 — the same function.

Usage: python -m tensorflow_web_deploy_tpu_torch.tools.make_artifacts
           [--models inception_v3,mobilenet_v2] [--out artifacts]
           [--width 1.0] [--size N]
"""

from __future__ import annotations

import argparse
import struct
import sys
from pathlib import Path

import numpy as np

from ..models import get as zoo_get
from ..models.adapter import init_variables
from ..models.common import DepthwiseConvBN
from ..ops.tf_ops import same_pads

DT_FLOAT = 1
DT_INT32 = 3
_DTYPES = {np.dtype(np.float32): DT_FLOAT, np.dtype(np.int32): DT_INT32}
# GraphDef version of the TF 2.21 runtime that froze the Keras graphs
PRODUCER = 2474

# --------------------------------------------------------------------------
# protobuf wire-format writer
# --------------------------------------------------------------------------


def _varint(n: int) -> bytes:
    n &= (1 << 64) - 1  # negative int64: two's complement, ten bytes
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _len(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


def _int(field: int, v: int) -> bytes:
    return _tag(field, 0) + _varint(int(v))


def _packed(field: int, vals) -> bytes:
    return _len(field, b"".join(_varint(int(v)) for v in vals))


def shape_proto(dims) -> bytes:
    """``TensorShapeProto``; -1 is an unknown dimension."""
    return b"".join(_len(2, _int(1, d)) for d in dims)


def tensor_proto(a: np.ndarray) -> bytes:
    """``TensorProto`` with the raw little-endian bytes in ``tensor_content``."""
    a = np.ascontiguousarray(a)
    return (_int(1, _DTYPES[a.dtype]) + _len(2, shape_proto(a.shape))
            + _len(4, a.astype(a.dtype.newbyteorder("<")).tobytes()))


def attr_value(kind: str, v) -> bytes:
    """``AttrValue`` of one kind: type, i, b, f, s, shape, tensor or ints."""
    if kind == "type":
        return _int(6, v)
    if kind == "i":
        return _int(3, v)
    if kind == "b":
        return _int(5, bool(v))
    if kind == "f":
        return _tag(4, 5) + struct.pack("<f", v)
    if kind == "s":
        return _len(2, v)
    if kind == "shape":
        return _len(7, shape_proto(v))
    if kind == "tensor":
        return _len(8, tensor_proto(v))
    if kind == "ints":
        return _len(1, _packed(3, v))  # ListValue.i, packed
    raise ValueError(f"unknown attr kind {kind!r}")


class GraphWriter:
    """Accumulates ``NodeDef``s; :meth:`serialize` gives the ``GraphDef``."""

    def __init__(self):
        self.nodes: list[bytes] = []
        self.reads: list[str] = []  # ReadVariableOp identities, for the NoOp

    def node(self, name: str, op: str, inputs=(), **attrs) -> str:
        body = _len(1, name.encode()) + _len(2, op.encode())
        body += b"".join(_len(3, i.encode()) for i in inputs)
        for key in sorted(attrs):
            kind, v = attrs[key]
            body += _len(5, _len(1, key.encode()) + _len(2, attr_value(kind, v)))
        self.nodes.append(body)
        return name

    def const(self, name: str, value: np.ndarray) -> str:
        value = np.asarray(value)
        return self.node(name, "Const", dtype=("type", _DTYPES[value.dtype]),
                         value=("tensor", value))

    def variable(self, name: str, value: np.ndarray) -> str:
        """A frozen variable: the const and its ``ReadVariableOp`` identity."""
        value = np.asarray(value, np.float32)
        self.const(f"{name}/resource", value)
        self.reads.append(self.node(name, "Identity", [f"{name}/resource"], T=_T))
        return name

    def serialize(self) -> bytes:
        versions = _len(4, _int(1, PRODUCER))
        return b"".join(_len(1, n) for n in self.nodes) + versions


_T = ("type", DT_FLOAT)


# --------------------------------------------------------------------------
# the zoo's modules as Keras-frozen graphs
# --------------------------------------------------------------------------


class _Emitter:
    def __init__(self, params: dict[str, np.ndarray], reshape_bn: bool, scope: str):
        self.g = GraphWriter()
        self.p = params
        self.reshape_bn = reshape_bn
        self.scope = scope

    def conv_bn(self, x: str, hw: tuple[int, int], path: str, cell):
        """One conv cell (``ConvBN`` or ``DepthwiseConvBN``) at input size
        ``hw``; returns (output node, output size)."""
        g, name = self.g, f"{self.scope}/{path}"
        depthwise = isinstance(cell, DepthwiseConvBN)
        attr = "dwconv" if depthwise else "conv"
        k = self.p[f"params/{path}/{attr}/kernel"]
        (kh, kw), s = cell.kernel, cell.stride
        pad = cell.padding
        if depthwise and s == 2 and pad == "SAME":
            # Keras's ZeroPadding2D before a VALID stride-2 depthwise conv
            pads = [same_pads(n, kk, s) for n, kk in zip(hw, (kh, kw))]
            x = g.node(f"{name}/pad/Pad", "Pad", [x, g.const(
                f"{name}/pad/Const", np.array([[0, 0], *pads, [0, 0]], np.int32))],
                T=_T, Tpaddings=("type", DT_INT32))
            hw = (hw[0] + sum(pads[0]), hw[1] + sum(pads[1]))
            pad = "VALID"
        if depthwise:
            w = g.variable(f"{name}/depthwise/ReadVariableOp", k.reshape(kh, kw, -1, 1))
            y = g.node(f"{name}/depthwise", "DepthwiseConv2dNative", [x, w], T=_T,
                       strides=("ints", [1, s, s, 1]), padding=("s", pad.encode()),
                       data_format=("s", b"NHWC"), dilations=("ints", [1, 1, 1, 1]))
        else:
            w = g.variable(f"{name}/convolution/ReadVariableOp", k)
            y = g.node(f"{name}/convolution", "Conv2D", [x, w], T=_T,
                       strides=("ints", [1, s, s, 1]), padding=("s", pad.encode()),
                       data_format=("s", b"NHWC"), dilations=("ints", [1, 1, 1, 1]),
                       use_cudnn_on_gpu=("b", True), explicit_paddings=("ints", []))
        if pad == "SAME":
            hw = tuple(-(-n // s) for n in hw)
        else:
            hw = ((hw[0] - kh) // s + 1, (hw[1] - kw) // s + 1)
        y = self.batch_norm(y, f"{path}/bn", f"{name}_bn")
        if cell.act is not None:
            op = {"relu": "Relu", "relu6": "Relu6"}[cell.act]
            y = g.node(f"{name}_act/{op}", op, [y], T=_T)
        return y, hw

    def batch_norm(self, x: str, path: str, name: str) -> str:
        g = self.g
        stats = {
            "Cast": self.p[f"batch_stats/{path}/mean"],
            "Cast_1": self.p[f"batch_stats/{path}/var"],
            "Cast_2": self.p[f"params/{path}/scale"],
            "Cast_3": self.p[f"params/{path}/bias"],
        }
        c = stats["Cast"].shape[0]
        v = {}
        for i, (cast, value) in enumerate(stats.items()):
            v[cast] = g.variable(f"{name}/{cast}/ReadVariableOp", value)
            if self.reshape_bn:
                shape = g.const(f"{name}/Reshape_{i}/shape", np.array([1, 1, 1, c], np.int32))
                v[cast] = g.node(f"{name}/Reshape_{i}", "Reshape", [v[cast], shape], T=_T,
                                 Tshape=("type", DT_INT32))
        eps = g.const(f"{name}/batchnorm/add/y", np.array(1e-3, np.float32))
        add = g.node(f"{name}/batchnorm/add", "AddV2", [v["Cast_1"], eps], T=_T)
        rsqrt = g.node(f"{name}/batchnorm/Rsqrt", "Rsqrt", [add], T=_T)
        mul = g.node(f"{name}/batchnorm/mul", "Mul", [rsqrt, v["Cast_2"]], T=_T)
        mul1 = g.node(f"{name}/batchnorm/mul_1", "Mul", [x, mul], T=_T)
        mul2 = g.node(f"{name}/batchnorm/mul_2", "Mul", [v["Cast"], mul], T=_T)
        sub = g.node(f"{name}/batchnorm/sub", "Sub", [v["Cast_3"], mul2], T=_T)
        return g.node(f"{name}/batchnorm/add_1", "AddV2", [mul1, sub], T=_T)

    def pool(self, x: str, name: str, op: str, k: int, s: int, padding: str) -> str:
        return self.g.node(name, op, [x], T=_T, ksize=("ints", [1, k, k, 1]),
                           strides=("ints", [1, s, s, 1]), padding=("s", padding.encode()),
                           data_format=("s", b"NHWC"))

    def avg_pool_counting_pads(self, x: str, hw: tuple[int, int], name: str) -> str:
        """The zoo's 3×3 stride-1 SAME average pool (the pads count, flax's
        rule): TF's ``AvgPool`` (valid taps only) times count/9."""
        y = self.pool(x, f"{name}/AvgPool", "AvgPool", 3, 1, "SAME")
        counts = [np.minimum(np.arange(n) + 1, n - 1) - np.maximum(np.arange(n) - 1, 0) + 1
                  for n in hw]
        fix = (np.outer(*counts) / 9.0).astype(np.float32).reshape(1, *hw, 1)
        return self.g.node(f"{name}/mul", "Mul", [y, self.g.const(f"{name}/counts", fix)], T=_T)

    def concat(self, xs: list[str], name: str) -> str:
        axis = self.g.const(f"{name}/concat/axis", np.array(3, np.int32))
        return self.g.node(f"{name}/concat", "ConcatV2", [*xs, axis], T=_T,
                           N=("i", len(xs)), Tidx=("type", DT_INT32))

    def head(self, x: str) -> str:
        g, name = self.g, self.scope
        axes = g.const(f"{name}/avg_pool/Mean/reduction_indices", np.array([1, 2], np.int32))
        x = g.node(f"{name}/avg_pool/Mean", "Mean", [x, axes], T=_T, keep_dims=("b", False),
                   Tidx=("type", DT_INT32))
        w = g.variable(f"{name}/predictions/Cast/ReadVariableOp", self.p["params/logits/kernel"])
        x = g.node(f"{name}/predictions/MatMul", "MatMul", [x, w], T=_T,
                   transpose_a=("b", False), transpose_b=("b", False))
        b = g.variable(f"{name}/predictions/BiasAdd/ReadVariableOp",
                       self.p["params/logits/bias"])
        x = g.node(f"{name}/predictions/BiasAdd", "BiasAdd", [x, b], T=_T,
                   data_format=("s", b"NHWC"))
        x = g.node(f"{name}/predictions/Softmax", "Softmax", [x], T=_T)
        g.node("NoOp", "NoOp", [f"^{r}" for r in g.reads])
        return g.node("Identity", "Identity", [x, "^NoOp"], T=_T)

    def placeholder(self, hw: tuple[int, int]) -> str:
        return self.g.node("input", "Placeholder", dtype=_T, shape=("shape", [-1, *hw, 3]))


def _emit_inception(e: _Emitter, model, hw) -> None:
    cell = lambda x, hw, path: e.conv_bn(x, hw, path, model.get_submodule(path.replace("/", ".")))  # noqa: E731
    x = e.placeholder(hw)
    for path in ("stem1", "stem2", "stem3"):
        x, hw = cell(x, hw, path)
    x, hw = e.pool(x, f"{e.scope}/max_pool_1/MaxPool2d", "MaxPool", 3, 2, "VALID"), \
        ((hw[0] - 3) // 2 + 1, (hw[1] - 3) // 2 + 1)
    for path in ("stem4", "stem5"):
        x, hw = cell(x, hw, path)
    x, hw = e.pool(x, f"{e.scope}/max_pool_2/MaxPool2d", "MaxPool", 3, 2, "VALID"), \
        ((hw[0] - 3) // 2 + 1, (hw[1] - 3) // 2 + 1)
    for name in model.block_names:
        block = getattr(model, name)

        def chain(x, hw, *paths):
            for p in paths:
                x, hw = cell(x, hw, f"{name}/{p}")
            return x, hw

        kind = type(block).__name__
        if kind in ("InceptionA", "InceptionB", "InceptionC"):
            outs = [chain(x, hw, "b1x1")[0]]
            if kind == "InceptionA":
                outs.append(chain(x, hw, "b5x5_1", "b5x5_2")[0])
                outs.append(chain(x, hw, "b3x3dbl_1", "b3x3dbl_2", "b3x3dbl_3")[0])
            elif kind == "InceptionB":
                outs.append(chain(x, hw, "b7x7_1", "b7x7_2", "b7x7_3")[0])
                outs.append(chain(x, hw, *(f"b7x7dbl_{i}" for i in range(1, 6)))[0])
            else:
                b3, _ = chain(x, hw, "b3x3_1")
                bd, _ = chain(x, hw, "b3x3dbl_1", "b3x3dbl_2")
                outs += [chain(b3, hw, "b3x3_2a")[0], chain(b3, hw, "b3x3_2b")[0],
                         chain(bd, hw, "b3x3dbl_3a")[0], chain(bd, hw, "b3x3dbl_3b")[0]]
            bp = e.avg_pool_counting_pads(x, hw, f"{e.scope}/{name}/pool")
            outs.append(chain(bp, hw, "bpool")[0])
            x = e.concat(outs, f"{e.scope}/{name}")
        else:  # the grid reductions
            if kind == "ReductionA":
                b3, out_hw = chain(x, hw, "b3x3")
                bd, _ = chain(x, hw, "b3x3dbl_1", "b3x3dbl_2", "b3x3dbl_3")
            else:
                b3, out_hw = chain(x, hw, "b3x3_1", "b3x3_2")
                bd, _ = chain(x, hw, *(f"b7x7x3_{i}" for i in range(1, 5)))
            mp = e.pool(x, f"{e.scope}/{name}/max_pool/MaxPool2d", "MaxPool", 3, 2, "VALID")
            x, hw = e.concat([b3, bd, mp], f"{e.scope}/{name}"), out_hw
    e.head(x)


def _emit_mobilenet(e: _Emitter, model, hw) -> None:
    x = e.placeholder(hw)
    x, hw = e.conv_bn(x, hw, "stem", model.stem)
    for name in model.block_names:
        block = getattr(model, name)
        h, hw2 = x, hw
        if block.expand is not None:
            h, hw2 = e.conv_bn(h, hw2, f"{name}/expand", block.expand)
        h, hw2 = e.conv_bn(h, hw2, f"{name}/dw", block.dw)
        h, hw2 = e.conv_bn(h, hw2, f"{name}/project", block.project)
        if block.residual:
            h = e.g.node(f"{e.scope}/{name}/add/add", "AddV2", [h, x], T=_T)
        x, hw = h, hw2
    x, hw = e.conv_bn(x, hw, "head", model.head)
    e.head(x)


_FAMILIES = {
    "inception_v3": (_emit_inception, True),
    "mobilenet_v2": (_emit_mobilenet, False),
}


def make_graph(name: str, size: int | None = None, width: float = 1.0,
               num_classes: int | None = None, seed: int = 0,
               params: dict[str, np.ndarray] | None = None) -> tuple[bytes, dict]:
    """The frozen ``GraphDef`` bytes of zoo model ``name`` at input side
    ``size`` (the spec's by default), and the weights that went into it in
    the zoo's flat layout: the seeded init for ``seed``, or ``params``."""
    if name not in _FAMILIES:
        raise ValueError(f"no frozen-graph emitter for {name!r} — have {sorted(_FAMILIES)}")
    spec = zoo_get(name)
    model, flat = init_variables(spec, num_classes=num_classes, width=width, seed=seed)
    if params is not None:
        flat = {k: np.asarray(params[k], np.float32) for k in flat}
    emit, reshape_bn = _FAMILIES[name]
    e = _Emitter(flat, reshape_bn, name)
    size = size or spec.input_size
    emit(e, model, (size, size))
    return e.g.serialize(), flat


def make_labels(out: Path) -> None:
    # No network → no real synset names; synthetic-but-stable label maps,
    # the same as the repo's tool writes.
    (out / "imagenet_labels.txt").write_text(
        "\n".join(f"class_{i:04d}" for i in range(1000)) + "\n")
    (out / "coco_labels.txt").write_text("\n".join(f"object_{i:02d}" for i in range(90)) + "\n")


def ensure_artifacts(models=None, out_dir="artifacts", width: float = 1.0,
                     size: int | None = None) -> Path:
    """Write any missing ``<name>.pb`` (the seed-0 weights) and the label
    files into ``out_dir``; cheap when they exist. Only the emitter's
    models."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    if not (out / "imagenet_labels.txt").exists():
        make_labels(out)
    for name in models or sorted(_FAMILIES):
        path = out / f"{name}.pb"
        if not path.exists():
            data, _ = make_graph(name, size=size, width=width)
            tmp = path.with_suffix(".pb.tmp")
            tmp.write_bytes(data)
            tmp.replace(path)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--models", default=",".join(sorted(_FAMILIES)))
    ap.add_argument("--out", default=str(Path(__file__).resolve().parents[2] / "artifacts"))
    ap.add_argument("--width", type=float, default=1.0)
    ap.add_argument("--size", type=int, default=None)
    args = ap.parse_args(argv)
    out = ensure_artifacts([m for m in args.models.split(",") if m], args.out,
                           width=args.width, size=args.size)
    for name in args.models.split(","):
        print(f"{out / (name + '.pb')}: {(out / (name + '.pb')).stat().st_size / 1e6:.1f} MB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
