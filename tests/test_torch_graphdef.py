"""The port's frozen-graph parser and op table against the JAX package's.

- ``graphdef/proto.py``: the port's copy parses the same bytes into the
  same nodes, attrs and arrays as the reference's (both fixtures).
- ``ops/tf_ops.py``: the port registers exactly the reference's op names
  with the same ``static_ok`` flags, and each handler family runs the same
  ``tf.compat.v1`` graph through the reference's converter (under
  ``jax.jit``) and through the port's (``ConvertedModel`` on the CPU):
  float32 within 1e-5, integer and index outputs exact. TensorFlow only
  builds the graphs.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tensorflow_web_deploy_tpu.graphdef import parse_graphdef as ref_parse
from tensorflow_web_deploy_tpu.ops import tf_ops as ref_ops
from tensorflow_web_deploy_tpu_torch.graphdef import convert_graphdef, parse_graphdef
from tensorflow_web_deploy_tpu_torch.ops import tf_ops
from tests.tf_golden import build_graph, convert_and_run

F32_TOL = 1e-5


def _same_value(a, b) -> bool:
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (isinstance(a, np.ndarray) and isinstance(b, np.ndarray) and a.dtype == b.dtype
                and a.shape == b.shape and np.array_equal(a, b, equal_nan=a.dtype.kind == "f"))
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(_same_value(x, y) for x, y in zip(a, b))
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("fixture", ["small_cls_pb", "small_ssd_pb"])
def test_parser_equals_the_reference(request, fixture):
    data = open(request.getfixturevalue(fixture), "rb").read()
    got, want = parse_graphdef(data), ref_parse(data)
    assert len(got.nodes) == len(want.nodes) > 100
    for g, w in zip(got.nodes, want.nodes):
        assert (g.name, g.op, g.inputs, g.device) == (w.name, w.op, w.inputs, w.device)
        assert sorted(g.attrs) == sorted(w.attrs), g.name
        for key in g.attrs:
            assert g.attrs[key].kind == w.attrs[key].kind, (g.name, key)
            assert _same_value(g.attrs[key].value, w.attrs[key].value), (g.name, key)
    assert sum(isinstance(n.attr("value"), np.ndarray) and n.attr("value").size > 1000
               for n in got.nodes) > 5  # the weights came through as arrays


def test_op_table_names_equal_the_reference():
    assert sorted(tf_ops.REGISTRY) == sorted(ref_ops.REGISTRY)
    assert {k for k, h in tf_ops.REGISTRY.items() if h.static_ok} == \
        {k for k, h in ref_ops.REGISTRY.items() if h.static_ok}


def test_unsupported_op_fails_at_conversion_naming_the_port_file():
    def build(tf):
        x = tf.compat.v1.placeholder(tf.float32, [2, 3], name="x")
        tf.math.cumsum(x, axis=1, name="out")

    graph = parse_graphdef(build_graph(build))
    with pytest.raises(NotImplementedError,
                       match="'Cumsum'.*tensorflow_web_deploy_tpu_torch/ops/tf_ops.py"):
        convert_graphdef(graph, outputs=["out"])


def _run_port(data: bytes, feeds: dict, fetches: list[str]) -> list[np.ndarray]:
    model = convert_graphdef(parse_graphdef(data), outputs=fetches)
    with torch.inference_mode():
        outs = model(*[torch.from_numpy(np.ascontiguousarray(feeds[n]))
                       for n in model.input_names])
    return [o.numpy() for o in outs]


def _assert_both(data: bytes, feeds: dict, fetches: list[str]) -> None:
    want = convert_and_run(data, feeds, fetches)
    got = _run_port(data, feeds, fetches)
    assert len(got) == len(want)
    for name, g, w in zip(fetches, got, want):
        assert g.shape == w.shape, name
        if w.dtype.kind == "f":
            assert g.dtype == w.dtype, name
            np.testing.assert_allclose(g, w, rtol=F32_TOL, atol=F32_TOL, err_msg=name)
        else:  # integers, booleans and indices: exact
            assert g.dtype.kind == w.dtype.kind, name
            np.testing.assert_array_equal(g, w, err_msg=name)


def _x(shape, seed=0, dtype=np.float32):
    return np.random.RandomState(seed).randn(*shape).astype(dtype)


def _ph(tf, shape, name="x", dtype=None):
    return tf.compat.v1.placeholder(dtype or tf.float32, shape, name=name)


# ---------------------------------------------------------------- conv / pool

CONV_CASES = [(pad, strides, size) for pad in ("SAME", "VALID")
              for strides in ((1, 1), (2, 2), (2, 1)) for size in (8, 9)]


@pytest.mark.parametrize("padding,strides,size", CONV_CASES)
def test_conv2d(padding, strides, size):
    """"SAME" on even and odd extents at stride 1 and 2: the odd pad goes
    at the bottom/right (an explicit F.pad)."""
    w = _x((3, 3, 3, 5), 1)

    def build(tf):
        tf.nn.conv2d(_ph(tf, [2, size, size, 3]), tf.constant(w), strides=[1, *strides, 1],
                     padding=padding, name="out")

    _assert_both(build_graph(build), {"x": _x((2, size, size, 3))}, ["out"])


@pytest.mark.parametrize("case", ["dilated", "explicit", "1x7"])
def test_conv2d_dilation_explicit_and_rectangular(case):
    w = _x((1, 7, 4, 6) if case == "1x7" else (3, 3, 4, 6), 2)

    def build(tf):
        x = _ph(tf, [1, 11, 10, 4])
        if case == "dilated":
            tf.nn.conv2d(x, tf.constant(w), [1, 1, 1, 1], "SAME", dilations=[1, 2, 2, 1],
                         name="out")
        elif case == "explicit":
            tf.nn.conv2d(x, tf.constant(w), [1, 2, 2, 1], [[0, 0], [0, 2], [1, 0], [0, 0]],
                         name="out")
        else:
            tf.nn.conv2d(x, tf.constant(w), [1, 1, 1, 1], "SAME", name="out")

    _assert_both(build_graph(build), {"x": _x((1, 11, 10, 4))}, ["out"])


@pytest.mark.parametrize("padding,stride,size,mult",
                         [(p, s, n, m) for p in ("SAME", "VALID") for s in (1, 2)
                          for n in (8, 9) for m in (1, 2)])
def test_depthwise_conv_channel_order(padding, stride, size, mult):
    """A [H, W, C, M] kernel: output channel c·M + m, a grouped conv."""
    w = _x((3, 3, 4, mult), 3)

    def build(tf):
        tf.nn.depthwise_conv2d(_ph(tf, [2, size, size, 4]), tf.constant(w),
                               [1, stride, stride, 1], padding, name="out")

    _assert_both(build_graph(build), {"x": _x((2, size, size, 4))}, ["out"])


POOL_CASES = [(op, pad, k, s, n) for op in ("max_pool2d", "avg_pool2d")
              for pad in ("SAME", "VALID") for k, s in ((3, 2), (2, 2), (3, 1), (2, 1))
              for n in (8, 9)]


@pytest.mark.parametrize("pool,padding,k,s,size", POOL_CASES)
def test_pooling(pool, padding, k, s, size):
    """SAME max pools pad with −inf; SAME average pools divide by the valid
    taps (symmetric pads and asymmetric ones, k 2 s 1, alike)."""
    def build(tf):
        getattr(tf.nn, pool)(_ph(tf, [2, size, size, 3]), k, s, padding, name="out")

    _assert_both(build_graph(build), {"x": _x((2, size, size, 3)) - 1.0}, ["out"])


# ----------------------------------------------------- norm / dense / activation


def test_fused_batch_norm_bias_add_and_matmuls():
    c = 6
    scale, offset, mean = _x((c,), 1), _x((c,), 2), _x((c,), 3)
    var = np.abs(_x((c,), 4)) + 0.5
    wa, wb = _x((5, 7), 5), _x((3, 2, 5), 6)

    def build(tf):
        x = _ph(tf, [2, 5, 5, c])
        y, *_ = tf.compat.v1.nn.fused_batch_norm(x, scale, offset, mean, var, epsilon=1e-3,
                                                 is_training=False)
        tf.identity(y, name="bn")
        tf.nn.bias_add(x, tf.constant(offset), name="bias")
        a = _ph(tf, [7, 5], "a")
        tf.matmul(a, tf.constant(wa), transpose_a=True, transpose_b=True, name="mm")
        b = _ph(tf, [3, 2, 4], "b")
        tf.raw_ops.BatchMatMulV2(x=b, y=tf.constant(wb), adj_x=True, name="bmm")

    _assert_both(build_graph(build), {"x": _x((2, 5, 5, c)), "a": _x((7, 5), 7),
                                      "b": _x((3, 2, 4), 8)}, ["bn", "bias", "mm", "bmm"])


ACTIVATIONS = ["relu", "relu6", "leaky_relu", "elu", "selu", "softplus", "sigmoid", "tanh",
               "softmax", "log_softmax"]


@pytest.mark.parametrize("act", ACTIVATIONS)
def test_activations(act):
    def build(tf):
        getattr(tf.nn, act)(_ph(tf, [3, 10]), name="out")

    _assert_both(build_graph(build), {"x": _x((3, 10)) * 4}, ["out"])


UNARY = sorted(ref_ops._UNARY)


@pytest.mark.parametrize("op", UNARY)
def test_unary(op):
    def build(tf):
        x = _ph(tf, [4, 6], dtype=tf.bool if op == "LogicalNot" else tf.float32)
        getattr(tf.raw_ops, op)(x=x, name="out")

    x = _x((4, 6)) * 3
    if op in ("Log", "Sqrt", "Rsqrt"):
        x = np.abs(x) + 0.1
    if op == "Log1p":
        x = np.abs(x)
    if op == "Round":
        x = np.round(x * 2) / 2  # halves: ties to even
    _assert_both(build_graph(build), {"x": x > 0 if op == "LogicalNot" else x}, ["out"])


BINARY = sorted(ref_ops._BINARY)


@pytest.mark.parametrize("op", BINARY)
def test_binary(op):
    """Float ops on floats, the integer ops on ints with negative values,
    the logical ones on booleans; one operand a broadcast constant."""
    logical = op in ("LogicalAnd", "LogicalOr")
    integer = op in ("FloorDiv", "FloorMod")
    dtype = np.bool_ if logical else np.int32 if integer else np.float32
    a = _x((3, 5), 1) * 4
    b = _x((5,), 2) * 4
    if logical:
        a, b = a > 0, b > 0
    elif integer:
        a, b = np.round(a).astype(np.int32), np.where(np.round(b) == 0, 3, np.round(b))
    elif op == "Pow":
        a = np.abs(a) + 0.5
    a, b = a.astype(dtype), b.astype(dtype)

    def build(tf):
        x = _ph(tf, [3, 5], dtype=tf.as_dtype(dtype))
        getattr(tf.raw_ops, op)(x=x, y=tf.constant(b), name="out")

    _assert_both(build_graph(build), {"x": a}, ["out"])


def test_add_n_select_clip_cast():
    def build(tf):
        x, y = _ph(tf, [4, 5]), _ph(tf, [4, 5], "y")
        tf.math.add_n([x, y, x], name="addn")
        tf.raw_ops.Select(condition=x > y, x=x, y=y, name="sel")
        tf.raw_ops.SelectV2(condition=x > 0, t=x, e=tf.constant(2.0), name="sel2")
        tf.clip_by_value(x, -0.5, tf.constant(0.7), name="clip")
        tf.cast(x * 3, tf.int32, name="cast")
        tf.cast(x > 0, tf.float32, name="castb")

    _assert_both(build_graph(build), {"x": _x((4, 5), 1), "y": _x((4, 5), 2)},
                 ["addn", "sel", "sel2", "clip", "cast", "castb"])


# ---------------------------------------------------------------- shape / layout


def test_shape_arithmetic_stays_static():
    """Shape → StridedSlice → Pack → Reshape, Size and Rank: host values
    at call time, so the Reshape has a static shape."""
    def build(tf):
        x = _ph(tf, [None, 4, 6])
        n = tf.shape(x)[0]
        y = tf.reshape(x, tf.stack([n, -1, 2]))
        tf.identity(y * tf.cast(tf.size(x), tf.float32) + tf.cast(tf.rank(x), tf.float32),
                    name="out")
        tf.identity(tf.shape(y), name="o_shape")

    _assert_both(build_graph(build), {"x": _x((3, 4, 6))}, ["out", "o_shape"])


def test_layout_ops():
    def build(tf):
        x = _ph(tf, [2, 1, 3, 4])
        y = tf.squeeze(x, axis=[1])
        tf.identity(tf.squeeze(tf.expand_dims(y, 0)), name="sq")
        tf.transpose(x, [0, 3, 1, 2], name="tr")
        a, b = tf.unstack(y, axis=1)[:2]
        tf.stack([a, b], axis=2, name="pack")
        tf.concat([y, y * 2], axis=-1, name="cat")
        tf.raw_ops.Concat(concat_dim=tf.constant(1), values=[y, y], name="cat_v1")
        p, q, r = tf.split(y, 3, axis=1)
        tf.identity(p - r + q, name="split")
        s1, s2 = tf.split(y, [1, 3], axis=2)
        tf.identity(tf.reduce_sum(s2, 2) + s1[:, :, 0], name="splitv")
        tf.tile(y, [1, 2, 1], name="tile")
        tf.identity(tf.raw_ops.IdentityN(input=[y, x])[0] + tf.stop_gradient(y), name="idn")
        tf.identity(tf.zeros_like(y) + tf.ones_like(y) * y, name="likes")

    _assert_both(build_graph(build), {"x": _x((2, 1, 3, 4))},
                 ["sq", "tr", "pack", "cat", "cat_v1", "split", "splitv", "tile", "idn",
                  "likes"])


@pytest.mark.parametrize("mode", ["CONSTANT", "REFLECT", "SYMMETRIC", "PadV2"])
def test_pads(mode):
    def build(tf):
        x = _ph(tf, [2, 5, 6, 3])
        pads = [[0, 0], [2, 1], [0, 3], [0, 0]]
        if mode == "PadV2":
            tf.raw_ops.PadV2(input=x, paddings=pads, constant_values=1.5, name="out")
        else:
            tf.pad(x, pads, mode=mode, name="out")

    _assert_both(build_graph(build), {"x": _x((2, 5, 6, 3))}, ["out"])


def test_slices_fill_range_gathers():
    idx = np.array([[2, 0], [1, 3], [0, 0]], np.int32)

    def build(tf):
        x = _ph(tf, [4, 8, 6])
        tf.slice(x, [1, 2, 0], [2, -1, 3], name="slice")
        tf.identity(x[1:3, ::2, -3:], name="ss")
        tf.identity(x[::-1, 5:1:-2, tf.newaxis, ..., 0], name="ss_neg")
        tf.identity(x[..., 1], name="ss_ell")
        tf.identity(x[:, :, 0] + tf.fill(tf.shape(x)[:2], 3.0), name="o_fill")
        tf.identity(x[0, 0] + tf.cast(tf.range(0, 12, 2), tf.float32), name="o_range")
        tf.gather(x, tf.constant([3, 0, 0, 2]), axis=1, name="gather")
        tf.gather(x, tf.constant(idx), axis=2, batch_dims=0, name="gather2d")
        tf.gather(x, tf.constant(np.array([[1, 0], [5, 5], [2, 3], [0, 1]], np.int32)),
                  axis=1, batch_dims=1, name="gather_bd")
        tf.gather_nd(x, tf.constant(np.array([[0, 1], [3, 7], [2, 2]], np.int32)),
                     name="gather_nd")

    _assert_both(build_graph(build), {"x": _x((4, 8, 6))},
                 ["slice", "ss", "ss_neg", "ss_ell", "o_fill", "o_range", "gather", "gather2d",
                  "gather_bd", "gather_nd"])


# ------------------------------------------------------ reductions / ties


@pytest.mark.parametrize("keep", [False, True])
def test_reductions(keep):
    def build(tf):
        x = _ph(tf, [3, 4, 5])
        for name, fn in (("mean", tf.reduce_mean), ("sum", tf.reduce_sum),
                         ("max", tf.reduce_max), ("min", tf.reduce_min),
                         ("prod", tf.reduce_prod)):
            fn(x, axis=[0, 2], keepdims=keep, name=name)
        tf.reduce_all(x > -1, axis=[1], keepdims=keep, name="all")
        tf.reduce_any(x > 1, axis=[0, 1], keepdims=keep, name="any")
        tf.reduce_mean(x, axis=[], name="noop")

    _assert_both(build_graph(build), {"x": _x((3, 4, 5))},
                 ["mean", "sum", "max", "min", "prod", "all", "any", "noop"])


def test_topk_and_argmax_break_ties_by_the_lower_index():
    """Many equal values: ``lax.top_k`` and ``jnp.argmax`` give the lower
    index first; so must the port (a stable sort, not ``torch.topk``)."""
    x = np.round(_x((6, 40), 3)).astype(np.float32)  # a handful of values, many ties

    def build(tf):
        v = _ph(tf, [6, 40])
        vals, idx = tf.math.top_k(v, k=12)
        tf.identity(vals, name="vals")
        tf.identity(idx, name="idx")
        tf.math.argmax(v, axis=1, name="amax")
        tf.math.argmin(v, axis=1, output_type=tf.int32, name="amin")

    _assert_both(build_graph(build), {"x": x}, ["vals", "idx", "amax", "amin"])


# ---------------------------------------------------------------------- resize

RESIZE_CASES = [(op, ac, hp, out) for op in ("ResizeBilinear", "ResizeNearestNeighbor")
                for ac, hp in ((False, False), (True, False), (False, True))
                for out in ((13, 7), (4, 11))]


@pytest.mark.parametrize("op,align_corners,half_pixel,out", RESIZE_CASES)
def test_resize_coordinates(op, align_corners, half_pixel, out):
    def build(tf):
        getattr(tf.raw_ops, op)(images=_ph(tf, [2, 6, 9, 3]), size=list(out),
                                align_corners=align_corners,
                                half_pixel_centers=half_pixel, name="out")

    _assert_both(build_graph(build), {"x": _x((2, 6, 9, 3))}, ["out"])
