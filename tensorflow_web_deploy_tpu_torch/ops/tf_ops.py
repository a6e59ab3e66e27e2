"""TF operator semantics on PyTorch (counterpart of the JAX package's
``ops/tf_ops.py``): the op table behind the frozen-graph converter
(:mod:`..graphdef.converter`). It registers exactly the reference's op
names, each handler reproducing one TensorFlow op's numerics as the
reference's handler does.

Handlers marked ``static_ok=True`` also run on plain numpy inputs; the
converter evaluates them in numpy whenever every input is static, so that
a frozen graph's ``Shape → StridedSlice → Pack → Reshape`` chains stay host
arithmetic and every tensor op has a static shape (the reference's rule).

Conventions:
- handler signature ``fn(node, inputs, xp)``: ``inputs`` are resolved input
  values (torch tensors, or numpy for static evaluation), ``xp`` is
  ``torch`` or ``numpy``;
- ``static_args`` are the input positions that must be host values (a
  reshape's shape, an axis, paddings, a slice's bounds): the converter
  keeps constants there in numpy and gives every other constant input to a
  tensor op as a tensor made once, at build;
- ``prepare`` maps an input position to its layout in the port (a conv's
  HWIO kernel → torch's OIHW, a depthwise ``[H, W, C, M]`` kernel →
  ``[C·M, 1, H, W]``), applied once at build to a constant and per call to
  a computed input;
- multi-output ops return tuples; consumers address them as ``"name:i"``.

Layout: frozen graphs are NHWC, and tensors stay NHWC in the logical sense.
A conv or pool takes ``x.permute(0, 3, 1, 2)`` — a ``channels_last`` view,
no copy, which cuDNN reads natively — and permutes its result back, so
``ConcatV2(axis=3)``, ``Mean(axis=[1, 2])`` and ``Reshape`` mean what the
graph says. Nothing here reads a device value on the host or builds a
device tensor from host data, so a forward is captured by a CUDA graph.

Numerical corners (as in the reference):
- TF ``SAME`` puts the extra pad at the bottom/right (``lax``'s rule); an
  asymmetric pad is an explicit ``F.pad``;
- ``AvgPool`` with ``SAME`` divides by the count of *valid* elements;
- ``MaxPool`` with ``SAME`` pads with −inf;
- ``TopKV2``, ``ArgMax``/``ArgMin`` give the lower index on ties (a stable
  descending sort, not ``torch.topk``);
- ``ResizeBilinear``/``ResizeNearestNeighbor`` implement all three TF
  coordinate conventions (legacy, ``align_corners``, ``half_pixel_centers``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F

from ..graphdef.proto import NodeDef, np_dtype


@dataclasses.dataclass
class OpHandler:
    fn: Callable[[NodeDef, list, Any], Any]
    static_ok: bool = False
    # input positions that must be host (numpy) values; negative counts
    # from the end
    static_args: tuple[int, ...] = ()
    # input position → the name of its layout in the port (``LAYOUTS``)
    prepare: dict[int, str] = dataclasses.field(default_factory=dict)

    def is_static_arg(self, pos: int, n_inputs: int) -> bool:
        return pos in self.static_args or pos - n_inputs in self.static_args


REGISTRY: dict[str, OpHandler] = {}


def register(*names: str, static_ok: bool = False, static_args: tuple[int, ...] = (),
             prepare: dict[int, str] | None = None):
    def deco(fn):
        for n in names:
            REGISTRY[n] = OpHandler(fn, static_ok, tuple(static_args), dict(prepare or {}))
        return fn

    return deco


def get_handler(op: str) -> OpHandler:
    try:
        return REGISTRY[op]
    except KeyError:
        raise NotImplementedError(
            f"TF op '{op}' has no torch handler; add one in "
            "tensorflow_web_deploy_tpu_torch/ops/tf_ops.py"
        ) from None


def _decode(v, default=None):
    if v is None:
        return default
    return v.decode() if isinstance(v, bytes) else v


def _hw(vals: list[int], data_format: str) -> tuple[int, int]:
    """Extract (H, W) entries from a 4-vector like strides/ksize."""
    if data_format.startswith("NC"):
        return int(vals[2]), int(vals[3])
    return int(vals[1]), int(vals[2])


def _np(x):
    """A host value as numpy (a CPU tensor converts; build time only)."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy() if x.dtype == torch.bfloat16 else x.detach().numpy()
    return np.asarray(x)


def _int_tuple(x) -> tuple[int, ...]:
    return tuple(int(v) for v in _np(x).reshape(-1))


def _scalar_int(x) -> int:
    return int(_np(x).reshape(-1)[0])


_TORCH_DTYPES = {
    "float32": torch.float32, "float64": torch.float64, "float16": torch.float16,
    "bfloat16": torch.bfloat16, "int8": torch.int8, "uint8": torch.uint8,
    "int16": torch.int16, "int32": torch.int32, "int64": torch.int64, "bool": torch.bool,
    "uint16": torch.uint16, "uint32": torch.uint32, "uint64": torch.uint64,
    "complex64": torch.complex64, "complex128": torch.complex128,
}


def torch_dtype(dt) -> torch.dtype:
    """A numpy dtype (``np_dtype``'s, ml_dtypes' bfloat16 included) → torch."""
    return _TORCH_DTYPES[np.dtype(dt).name]


def as_tensor(v, like: torch.Tensor | None = None) -> torch.Tensor:
    """A numpy value as a tensor on ``like``'s device. A host copy: the
    converter makes every constant operand a tensor at build, so at call
    time this only meets values computed from shapes."""
    if isinstance(v, torch.Tensor):
        return v
    a = np.asarray(v)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        a = np.ascontiguousarray(a)
        t = torch.from_numpy(a if a.flags.writeable else a.copy())
    return t.to(like.device) if like is not None else t


def _tensors(*vals):
    """Every value of a torch-path op as a tensor on the first tensor's device."""
    like = next((v for v in vals if isinstance(v, torch.Tensor)), None)
    return [as_tensor(v, like) for v in vals]


def _nhwc_to_nchw(x):
    return x.permute(0, 3, 1, 2)


def _nchw_to_nhwc(x):
    return x.permute(0, 2, 3, 1)


def same_pads(size: int, k: int, stride: int, dilation: int = 1) -> tuple[int, int]:
    """(lo, hi) "SAME" pads of one axis, ``lax.padtype_to_pads``'s rule:
    ⌈size/stride⌉ outputs, and an odd total pad puts its extra row at the
    end."""
    eff = (k - 1) * dilation + 1
    out = -(-size // stride)
    total = max((out - 1) * stride + eff - size, 0)
    return total // 2, total - total // 2


# --------------------------------------------------------------------------
# convolution / pooling
# --------------------------------------------------------------------------


def _conv_pads(node: NodeDef, data_format: str, hw, kernel, strides, dilations):
    """((top, bottom), (left, right)) of a conv: SAME, VALID or EXPLICIT."""
    pad = _decode(node.attr("padding"), "VALID")
    if pad == "EXPLICIT":
        ep = node.attr("explicit_paddings")
        # explicit_paddings is a flat [lo, hi] per dimension of the data layout.
        pairs = [(int(ep[2 * i]), int(ep[2 * i + 1])) for i in range(4)]
        return (pairs[2], pairs[3]) if data_format.startswith("NC") else (pairs[1], pairs[2])
    if pad == "SAME":
        return tuple(same_pads(n, k, s, d) for n, k, s, d in zip(hw, kernel, strides, dilations))
    return (0, 0), (0, 0)


def _conv_nchw(x, w, pads, strides, dilations, groups: int = 1):
    """F.conv2d on an NCHW tensor with TF's pads (asymmetric: explicit F.pad)."""
    (pt, pb), (pl, pr) = pads
    if pt == pb and pl == pr:
        return F.conv2d(x, w, None, strides, (pt, pl), dilations, groups)
    x = F.pad(x, (pl, pr, pt, pb))
    return F.conv2d(x, w, None, strides, 0, dilations, groups)


def _depthwise_to_grouped(w):
    # TF depthwise kernel is [H, W, C, M] with output channel order c*M + m —
    # a grouped conv with C groups over a [C*M, 1, H, W] kernel.
    kh, kw, c, m = w.shape
    return w.reshape(kh, kw, 1, c * m).permute(3, 2, 0, 1)


# a kernel in the TF layout → the port's: a conv's HWIO → OIHW, a depthwise
# [H, W, C, M] → [C·M, 1, H, W]
LAYOUTS: dict[str, Callable] = {
    "oihw": lambda w: w.permute(3, 2, 0, 1),
    "grouped": _depthwise_to_grouped,
}


def _conv(node, x, w, groups_of):
    df = _decode(node.attr("data_format"), "NHWC")
    strides = _hw(node.attr("strides"), df)
    dilations = _hw(node.attr("dilations", [1, 1, 1, 1]), df)
    nchw = df.startswith("NC")
    xc = x if nchw else _nhwc_to_nchw(x)
    pads = _conv_pads(node, df, xc.shape[2:], w.shape[2:], strides, dilations)
    y = _conv_nchw(xc, w, pads, strides, dilations, groups_of(xc))
    return y if nchw else _nchw_to_nhwc(y)


@register("Conv2D", prepare={1: "oihw"})
def _conv2d(node, inputs, xp):
    x, w = inputs  # w: OIHW
    return _conv(node, x, w, lambda xc: xc.shape[1] // w.shape[1])


@register("DepthwiseConv2dNative", prepare={1: "grouped"})
def _depthwise_conv(node, inputs, xp):
    x, w = inputs  # w: [C*M, 1, H, W]
    return _conv(node, x, w, lambda xc: xc.shape[1])


def _pool_setup(node, x):
    """(NCHW view, window (kh, kw), strides, pads, back-permute) of a pool."""
    df = _decode(node.attr("data_format"), "NHWC")
    window = _hw(node.attr("ksize"), df)
    strides = _hw(node.attr("strides"), df)
    nchw = df.startswith("NC")
    xc = x if nchw else _nhwc_to_nchw(x)
    if _decode(node.attr("padding"), "VALID") == "SAME":
        pads = tuple(same_pads(n, k, s) for n, k, s in zip(xc.shape[2:], window, strides))
    else:
        pads = ((0, 0), (0, 0))
    return xc, window, strides, pads, (lambda y: y) if nchw else _nchw_to_nhwc


@register("MaxPool")
def _max_pool(node, inputs, xp):
    (x,) = inputs
    xc, window, strides, ((pt, pb), (pl, pr)), back = _pool_setup(node, x)
    if pt or pb or pl or pr:
        init = -math.inf if x.is_floating_point() else torch.iinfo(x.dtype).min
        xc = F.pad(xc, (pl, pr, pt, pb), value=init)
    return back(F.max_pool2d(xc, window, strides))


@register("AvgPool")
def _avg_pool(node, inputs, xp):
    (x,) = inputs
    xc, window, strides, ((pt, pb), (pl, pr)), back = _pool_setup(node, x)
    if not (pt or pb or pl or pr):
        return back(F.avg_pool2d(xc, window, strides))
    # TF SAME-padded AvgPool divides by the count of *valid* (non-pad) elements.
    if pt == pb and pl == pr and 2 * pt <= window[0] and 2 * pl <= window[1]:
        return back(F.avg_pool2d(xc, window, strides, (pt, pl), count_include_pad=False))
    pad = (pl, pr, pt, pb)
    summed = F.avg_pool2d(F.pad(xc, pad), window, strides, divisor_override=1)
    ones = torch.ones((1, 1, *xc.shape[2:]), dtype=x.dtype, device=x.device)
    counts = F.avg_pool2d(F.pad(ones, pad), window, strides, divisor_override=1)
    return back(summed / counts)


# --------------------------------------------------------------------------
# normalization / dense / activations
# --------------------------------------------------------------------------


@register("FusedBatchNorm", "FusedBatchNormV2", "FusedBatchNormV3")
def _fused_batch_norm(node, inputs, xp):
    x, scale, offset, mean, var = _tensors(*inputs)
    eps = node.attr("epsilon", 1e-3)
    df = _decode(node.attr("data_format"), "NHWC")
    shape = (1, -1, 1, 1) if df.startswith("NC") else (1, 1, 1, -1)
    inv = scale * torch.rsqrt(var + torch.full((), eps, dtype=var.dtype, device=var.device))
    y = (x - mean.reshape(shape)) * inv.reshape(shape) + offset.reshape(shape)
    y = y.to(x.dtype)
    # Inference consumers only read output 0; batch stats echoed for parity.
    return (y, mean, var, mean, var, mean)


@register("BiasAdd")
def _bias_add(node, inputs, xp):
    x, b = _tensors(*inputs)
    df = _decode(node.attr("data_format"), "NHWC")
    if df.startswith("NC") and x.dim() == 4:
        return x + b.reshape(1, -1, 1, 1)
    return x + b


@register("MatMul")
def _matmul(node, inputs, xp):
    a, b = _tensors(*inputs)
    if node.attr("transpose_a", False):
        a = a.t()
    if node.attr("transpose_b", False):
        b = b.t()
    return torch.matmul(a, b)


@register("BatchMatMul", "BatchMatMulV2", "BatchMatMulV3")
def _batch_matmul(node, inputs, xp):
    a, b = _tensors(*inputs)
    if node.attr("adj_x", False):
        a = a.transpose(-1, -2)
    if node.attr("adj_y", False):
        b = b.transpose(-1, -2)
    return torch.matmul(a, b)


def _unary(fn):
    return lambda node, inputs, xp: fn(as_tensor(inputs[0]))


register("Relu")(_unary(F.relu))
register("Relu6")(_unary(lambda x: torch.clamp(x, 0, 6)))
register("Elu")(_unary(F.elu))
register("Selu")(_unary(F.selu))
register("Softplus")(_unary(F.softplus))
register("Sigmoid")(_unary(torch.sigmoid))
register("Tanh")(_unary(torch.tanh))
register("Softmax")(_unary(lambda x: torch.softmax(x, dim=-1)))
register("LogSoftmax")(_unary(lambda x: torch.log_softmax(x, dim=-1)))


@register("LeakyRelu")
def _leaky_relu(node, inputs, xp):
    return F.leaky_relu(as_tensor(inputs[0]), node.attr("alpha", 0.2))


# --------------------------------------------------------------------------
# elementwise
# --------------------------------------------------------------------------

_UNARY = {
    "Neg": torch.neg,
    "Abs": torch.abs,
    "Exp": torch.exp,
    "Log": torch.log,
    "Log1p": torch.log1p,
    "Sqrt": torch.sqrt,
    "Rsqrt": torch.rsqrt,
    "Square": lambda x: x * x,
    "Reciprocal": torch.reciprocal,
    "Floor": torch.floor,
    "Ceil": torch.ceil,
    "Round": torch.round,  # half to even, as jnp.round
    "Sign": torch.sign,
    "Erf": torch.erf,
    "Sin": torch.sin,
    "Cos": torch.cos,
    "LogicalNot": torch.logical_not,
}

for _name, _f in _UNARY.items():
    register(_name)(_unary(_f))


_BINARY = {
    "Add": lambda a, b, xp: a + b,
    "AddV2": lambda a, b, xp: a + b,
    "Sub": lambda a, b, xp: a - b,
    "Mul": lambda a, b, xp: a * b,
    "RealDiv": lambda a, b, xp: a / b,
    "Div": lambda a, b, xp: a / b,
    "FloorDiv": lambda a, b, xp: xp.floor_divide(a, b),
    "FloorMod": lambda a, b, xp: np.mod(a, b) if xp is np else torch.remainder(a, b),
    "Maximum": lambda a, b, xp: xp.maximum(a, b),
    "Minimum": lambda a, b, xp: xp.minimum(a, b),
    "Pow": lambda a, b, xp: np.power(a, b) if xp is np else torch.pow(a, b),
    "SquaredDifference": lambda a, b, xp: (a - b) * (a - b),
    "Equal": lambda a, b, xp: a == b,
    "NotEqual": lambda a, b, xp: a != b,
    "Greater": lambda a, b, xp: a > b,
    "GreaterEqual": lambda a, b, xp: a >= b,
    "Less": lambda a, b, xp: a < b,
    "LessEqual": lambda a, b, xp: a <= b,
    "LogicalAnd": lambda a, b, xp: xp.logical_and(a, b),
    "LogicalOr": lambda a, b, xp: xp.logical_or(a, b),
}


def _binary(f):
    def handler(node, inputs, xp):
        a, b = inputs if xp is np else _tensors(*inputs)
        return f(a, b, xp)

    return handler


for _name, _f in _BINARY.items():
    register(_name, static_ok=True)(_binary(_f))


@register("AddN")
def _add_n(node, inputs, xp):
    vals = _tensors(*inputs)
    out = vals[0]
    for x in vals[1:]:
        out = out + x
    return out


@register("Select", "SelectV2")
def _select(node, inputs, xp):
    c, a, b = _tensors(*inputs)
    return torch.where(c, a, b)


@register("ClipByValue")
def _clip(node, inputs, xp):
    x, lo, hi = _tensors(*inputs)
    return torch.clamp(x, lo, hi)


@register("Cast", static_ok=True)
def _cast(node, inputs, xp):
    dt = np_dtype(node.attr("DstT"))
    x = inputs[0]
    if xp is np:
        return np.asarray(x).astype(dt)
    return as_tensor(x).to(torch_dtype(dt))


# --------------------------------------------------------------------------
# shape / layout
# --------------------------------------------------------------------------


@register("Identity", "StopGradient", "PreventGradient", "CheckNumerics", "Snapshot",
          static_ok=True)
def _identity(node, inputs, xp):
    return inputs[0]


@register("IdentityN", static_ok=True)
def _identity_n(node, inputs, xp):
    return tuple(inputs)


@register("Shape")
def _shape(node, inputs, xp):
    # Shapes are static, so Shape always yields a host numpy vector — this
    # is what keeps a downstream Reshape's shape host arithmetic.
    dt = np_dtype(node.attr("out_type", 3))
    return np.array(tuple(inputs[0].shape), dt)


@register("Size")
def _size(node, inputs, xp):
    dt = np_dtype(node.attr("out_type", 3))
    return np.array(math.prod(inputs[0].shape), dt)


@register("Rank")
def _rank(node, inputs, xp):
    return np.array(len(inputs[0].shape), np.int32)


@register("Reshape", static_ok=True, static_args=(1,))
def _reshape(node, inputs, xp):
    x, shape = inputs
    return x.reshape(_int_tuple(shape))


@register("Squeeze", static_ok=True)
def _squeeze(node, inputs, xp):
    x = inputs[0]
    dims = node.attr("squeeze_dims") or node.attr("axis")
    if not dims:
        return xp.squeeze(x)
    dims = tuple(int(d) for d in dims)
    return np.squeeze(x, axis=dims) if xp is np else torch.squeeze(x, dims)


@register("ExpandDims", static_ok=True, static_args=(1,))
def _expand_dims(node, inputs, xp):
    x, axis = inputs
    axis = _scalar_int(axis)
    return np.expand_dims(x, axis) if xp is np else torch.unsqueeze(x, axis)


@register("Transpose", static_ok=True, static_args=(1,))
def _transpose(node, inputs, xp):
    x, perm = inputs
    perm = _int_tuple(perm)
    return np.transpose(x, perm) if xp is np else x.permute(perm)


@register("Pack", static_ok=True)
def _pack(node, inputs, xp):
    axis = node.attr("axis", 0)
    if xp is np:
        return np.stack(inputs, axis=axis)
    return torch.stack(_tensors(*inputs), dim=axis)


@register("Unpack")
def _unpack(node, inputs, xp):
    x = as_tensor(inputs[0])
    axis = node.attr("axis", 0)
    return tuple(torch.unbind(x, axis))


@register("ConcatV2", static_ok=True, static_args=(-1,))
def _concat_v2(node, inputs, xp):
    *vals, axis = inputs
    axis = _scalar_int(axis)
    if xp is np:
        return np.concatenate(vals, axis=axis)
    return torch.cat(_tensors(*vals), dim=axis)


@register("Concat", static_args=(0,))
def _concat(node, inputs, xp):
    axis, *vals = inputs
    return torch.cat(_tensors(*vals), dim=_scalar_int(axis))


@register("Split", static_args=(0,))
def _split(node, inputs, xp):
    axis, x = inputs
    return tuple(torch.tensor_split(as_tensor(x), node.attr("num_split"), dim=_scalar_int(axis)))


@register("SplitV", static_args=(1, 2))
def _split_v(node, inputs, xp):
    x, sizes, axis = inputs
    offsets = np.cumsum(_int_tuple(sizes))[:-1].tolist()
    return tuple(torch.tensor_split(as_tensor(x), offsets, dim=_scalar_int(axis)))


@register("Pad", "PadV2", static_ok=True, static_args=(1, 2))
def _pad(node, inputs, xp):
    x = inputs[0]
    paddings = [(int(lo), int(hi)) for lo, hi in _np(inputs[1]).reshape(-1, 2)]
    value = 0 if len(inputs) < 3 else _np(inputs[2]).reshape(-1)[0].item()
    if xp is np:
        return np.pad(x, paddings, constant_values=value)
    flat = [p for lo_hi in reversed(paddings) for p in lo_hi]
    return F.pad(x, flat, value=value)


@register("MirrorPad", static_args=(1,))
def _mirror_pad(node, inputs, xp):
    x, paddings = inputs
    x = as_tensor(x)
    reflect = _decode(node.attr("mode"), "REFLECT").lower() == "reflect"
    for axis, (lo, hi) in enumerate(_np(paddings).reshape(-1, 2).tolist()):
        n = x.shape[axis]
        parts = []
        if lo:  # reflect skips the edge row; symmetric repeats it
            parts.append(x.narrow(axis, 1 if reflect else 0, lo).flip(axis))
        parts.append(x)
        if hi:
            parts.append(x.narrow(axis, n - hi - (1 if reflect else 0), hi).flip(axis))
        if len(parts) > 1:
            x = torch.cat(parts, dim=axis)
    return x


@register("Slice", static_ok=True, static_args=(1, 2))
def _slice(node, inputs, xp):
    x, begin, size = inputs
    begin = _int_tuple(begin)
    size = _int_tuple(size)
    idx = tuple(slice(b, None if s == -1 else b + s) for b, s in zip(begin, size))
    return x[idx]


def _torch_index(x: torch.Tensor, idx: list) -> torch.Tensor:
    """numpy basic indexing (ints, slices with any step, None, Ellipsis) on
    a tensor: torch slices take positive steps only, so a negative step is
    a flip and a positive-step slice."""
    if all(not isinstance(i, slice) or (i.step or 1) > 0 for i in idx):
        return x[tuple(idx)]
    consumed = sum(1 for i in idx if i is not None and i is not Ellipsis)
    items: list = []
    for i in idx:
        if i is Ellipsis:
            items.extend([slice(None)] * (x.dim() - consumed))
        else:
            items.append(i)
    d = 0
    for i in items:
        if i is None:
            x = x.unsqueeze(d)
            d += 1
        elif isinstance(i, int):
            x = x.select(d, i)
        else:
            start, stop, step = i.indices(x.shape[d])
            if step > 0:
                x = x[(slice(None),) * d + (slice(start, stop, step),)]
            else:
                count = len(range(start, stop, step))
                if count == 0:
                    x = x.narrow(d, 0, 0)
                else:
                    j0 = x.shape[d] - 1 - start
                    x = x.flip(d)[(slice(None),) * d + (slice(j0, j0 - step * (count - 1) + 1,
                                                              -step),)]
            d += 1
    return x


@register("StridedSlice", static_ok=True, static_args=(1, 2, 3))
def _strided_slice(node, inputs, xp):
    x, begin, end, strides = inputs
    begin, end, strides = _int_tuple(begin), _int_tuple(end), _int_tuple(strides)
    bm = node.attr("begin_mask", 0)
    em = node.attr("end_mask", 0)
    ellm = node.attr("ellipsis_mask", 0)
    nam = node.attr("new_axis_mask", 0)
    sam = node.attr("shrink_axis_mask", 0)
    idx: list = []
    for i in range(len(begin)):
        bit = 1 << i
        if ellm & bit:
            idx.append(Ellipsis)
        elif nam & bit:
            idx.append(None)
        elif sam & bit:
            idx.append(int(begin[i]))
        else:
            b = None if bm & bit else int(begin[i])
            e = None if em & bit else int(end[i])
            idx.append(slice(b, e, int(strides[i])))
    return x[tuple(idx)] if xp is np else _torch_index(x, idx)


@register("Fill", static_ok=True, static_args=(0,))
def _fill(node, inputs, xp):
    dims, value = inputs
    dims = _int_tuple(dims)
    if xp is np:
        return np.full(dims, value)
    return as_tensor(value).reshape(()).expand(dims).contiguous()


@register("Range", static_ok=True, static_args=(0, 1, 2))
def _range(node, inputs, xp):
    start, limit, delta = (_np(v).item() for v in inputs)
    # The output's length must be static, so Range always evaluates in numpy.
    return np.arange(start, limit, delta)


@register("Tile", static_ok=True, static_args=(1,))
def _tile(node, inputs, xp):
    x, multiples = inputs
    multiples = _int_tuple(multiples)
    return np.tile(x, multiples) if xp is np else torch.tile(x, multiples)


def _take(params: torch.Tensor, indices: torch.Tensor, axis: int, batch_dims: int = 0):
    """``np.take`` along ``axis``, with TF's leading ``batch_dims`` aligned."""
    idx = indices.long()
    nb, ni = batch_dims, idx.dim() - batch_dims
    p = params.movedim(axis, nb)
    lead = []
    for d in range(nb):  # each batch axis indexes itself
        shape = [1] * idx.dim()
        shape[d] = idx.shape[d]
        lead.append(torch.arange(idx.shape[d], device=idx.device).reshape(shape))
    g = p[(*lead, idx)]  # batch..., indices..., the rest of params in order
    return g.movedim(list(range(nb, nb + ni)), list(range(axis, axis + ni)))


@register("GatherV2", static_ok=True, static_args=(2,))
def _gather_v2(node, inputs, xp):
    params, indices, axis = inputs
    axis = _scalar_int(axis)
    batch_dims = node.attr("batch_dims", 0)
    if xp is np and not batch_dims:
        return np.take(params, np.asarray(indices), axis=axis)
    params, indices = _tensors(params, indices)
    axis = axis % params.dim()
    batch_dims = batch_dims % indices.dim() if batch_dims else 0
    return _take(params, indices, axis, batch_dims)


@register("GatherNd")
def _gather_nd(node, inputs, xp):
    params, indices = _tensors(*inputs)
    return params[tuple(indices.long().movedim(-1, 0))]


@register("ZerosLike", static_ok=True)
def _zeros_like(node, inputs, xp):
    return np.zeros_like(inputs[0]) if xp is np else torch.zeros_like(inputs[0])


@register("OnesLike", static_ok=True)
def _ones_like(node, inputs, xp):
    return np.ones_like(inputs[0]) if xp is np else torch.ones_like(inputs[0])


# --------------------------------------------------------------------------
# reductions / argmax / top-k
# --------------------------------------------------------------------------


def _per_axis(fn):
    """A torch reduction over one dim at a time, highest dim first."""
    def reduce(x, axis, keepdims):
        for a in sorted((a % x.dim() for a in axis), reverse=True):
            x = fn(x, a, keepdims)
        return x

    return reduce


_TORCH_REDUCE = {
    "Mean": lambda x, axis, keepdims: torch.mean(
        x if x.is_floating_point() else x.float(), dim=axis, keepdim=keepdims),
    "Sum": lambda x, axis, keepdims: torch.sum(x, dim=axis, keepdim=keepdims),
    "Max": lambda x, axis, keepdims: torch.amax(x, dim=axis, keepdim=keepdims),
    "Min": lambda x, axis, keepdims: torch.amin(x, dim=axis, keepdim=keepdims),
    "Prod": _per_axis(lambda x, a, k: torch.prod(x, dim=a, keepdim=k)),
    "All": _per_axis(lambda x, a, k: torch.all(x, dim=a, keepdim=k)),
    "Any": _per_axis(lambda x, a, k: torch.any(x, dim=a, keepdim=k)),
}
_NP_REDUCE = {"Mean": np.mean, "Sum": np.sum, "Max": np.max, "Min": np.min, "Prod": np.prod,
              "All": np.all, "Any": np.any}


def _reduction(op: str):
    def handler(node, inputs, xp):
        x, axes = inputs
        axes = tuple(int(a) for a in _np(axes).reshape(-1))
        if not axes:
            return x  # TF: empty reduction_indices is a no-op, NOT reduce-all
        keep = bool(node.attr("keep_dims", node.attr("keepdims", False)))
        if xp is np:
            return _NP_REDUCE[op](x, axis=axes, keepdims=keep)
        return _TORCH_REDUCE[op](as_tensor(x), axes, keep)

    return handler


for _name in _NP_REDUCE:
    register(_name, static_ok=True, static_args=(1,))(_reduction(_name))


@register("ArgMax", static_args=(1,))
def _argmax(node, inputs, xp):
    x, axis = inputs
    dt = torch_dtype(np_dtype(node.attr("output_type", 9)))
    # torch.argmax returns the first maximal index, as jnp.argmax does
    return torch.argmax(as_tensor(x), dim=_scalar_int(axis)).to(dt)


@register("ArgMin", static_args=(1,))
def _argmin(node, inputs, xp):
    x, axis = inputs
    dt = torch_dtype(np_dtype(node.attr("output_type", 9)))
    return torch.argmin(as_tensor(x), dim=_scalar_int(axis)).to(dt)


_BITS = {torch.float32: torch.int32, torch.float64: torch.int64, torch.bfloat16: torch.int16,
         torch.float16: torch.int16}


def _total_order(x: torch.Tensor) -> torch.Tensor:
    """Integer keys that order floats as ``lax.top_k`` does: by value, with
    −0 below +0 (the IEEE total order; NaN above +inf)."""
    it = _BITS.get(x.dtype)
    if it is None:
        return x
    bits = x.view(it)
    return bits ^ ((bits >> (torch.iinfo(it).bits - 1)) & torch.iinfo(it).max)


@register("TopKV2", static_args=(1,))
def _top_k(node, inputs, xp):
    x, k = inputs
    x = as_tensor(x)
    k = _scalar_int(k)
    # lax.top_k breaks ties by the lower index; a stable descending sort
    # keeps equal keys in index order (torch.topk promises no order)
    _, indices = torch.sort(_total_order(x), dim=-1, descending=True, stable=True)
    indices = indices[..., :k]
    return torch.gather(x, -1, indices), indices.to(torch.int32)


# --------------------------------------------------------------------------
# image resize (TF coordinate conventions)
# --------------------------------------------------------------------------


def _resize_coords(out_size: int, in_size: int, align_corners: bool, half_pixel: bool,
                   device) -> torch.Tensor:
    i = torch.arange(out_size, dtype=torch.float32, device=device)
    if align_corners and out_size > 1:
        return i * ((in_size - 1) / (out_size - 1))
    if half_pixel:
        return (i + 0.5) * (in_size / out_size) - 0.5
    return i * (in_size / out_size)


def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int, align_corners: bool = False,
                    half_pixel_centers: bool = False) -> torch.Tensor:
    """NHWC bilinear resize matching ``tf.image.resize``/``ResizeBilinear``."""
    _, in_h, in_w, _ = x.shape
    dtype = x.dtype
    x = x.float()

    def axis_weights(out_size, in_size):
        coords = _resize_coords(out_size, in_size, align_corners, half_pixel_centers, x.device)
        coords = torch.clamp(coords, 0.0, in_size - 1)
        lo = torch.floor(coords).to(torch.int64)
        hi = torch.clamp(lo + 1, max=in_size - 1)
        return lo, hi, coords - lo

    h_lo, h_hi, h_w = axis_weights(out_h, in_h)
    w_lo, w_hi, w_w = axis_weights(out_w, in_w)
    top = x[:, h_lo] * (1 - h_w)[None, :, None, None] + x[:, h_hi] * h_w[None, :, None, None]
    out = (top[:, :, w_lo] * (1 - w_w)[None, None, :, None]
           + top[:, :, w_hi] * w_w[None, None, :, None])
    return out.to(dtype) if dtype.is_floating_point else out


def resize_nearest(x: torch.Tensor, out_h: int, out_w: int, align_corners: bool = False,
                   half_pixel_centers: bool = False) -> torch.Tensor:
    _, in_h, in_w, _ = x.shape

    def axis_idx(out_size, in_size):
        i = torch.arange(out_size, dtype=torch.float32, device=x.device)
        if align_corners and out_size > 1:
            # TF uses C roundf (half away from zero): floor(c + 0.5) for the
            # non-negative coords here
            idx = torch.floor(i * ((in_size - 1) / (out_size - 1)) + 0.5)
        elif half_pixel_centers:
            # nearest's half-pixel scaler is (i + 0.5) * scale with NO -0.5
            # shift (unlike bilinear's) — TF HalfPixelScalerForNN
            idx = torch.floor((i + 0.5) * (in_size / out_size))
        else:
            idx = torch.floor(i * (in_size / out_size))
        return torch.clamp(idx.to(torch.int64), 0, in_size - 1)

    return x[:, axis_idx(out_h, in_h)][:, :, axis_idx(out_w, in_w)]


@register("ResizeBilinear", static_args=(1,))
def _resize_bilinear_op(node, inputs, xp):
    x, size = inputs
    out_h, out_w = _int_tuple(size)
    return resize_bilinear(as_tensor(x), out_h, out_w,
                           align_corners=node.attr("align_corners", False),
                           half_pixel_centers=node.attr("half_pixel_centers", False))


@register("ResizeNearestNeighbor", static_args=(1,))
def _resize_nearest_op(node, inputs, xp):
    x, size = inputs
    out_h, out_w = _int_tuple(size)
    return resize_nearest(as_tensor(x), out_h, out_w,
                          align_corners=node.attr("align_corners", False),
                          half_pixel_centers=node.attr("half_pixel_centers", False))
