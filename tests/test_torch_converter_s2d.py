"""The port's frozen-graph stem rewrite (graphdef/converter.py ``S2DStem``)
against the JAX package's, on the CPU: the reference's
``tests/test_converter_s2d.py`` cases through both converters.

The same TF graphs are detected or refused by both, with the same
``supports``, pads and absorbed ``Pad``; the port's cells-consuming variant
equals its unrewritten graph and the reference's variant (float32, 1e-5);
wide, stride-1 and shared-input stems are not rewritten; a frozen Keras
MobileNetV2 is served with the handshake on the yuv420 wire, as the
reference serves it; and the port's one difference, the ``cin == 3`` gate:
a stride-2 stem over one channel (a grouped conv of the 3-channel image)
serves on the yuv420 wire without the handshake, where the reference's
engine turns the handshake on and fails.
"""

import jax
import numpy as np
import pytest
import torch

from tensorflow_web_deploy_tpu.graphdef.converter import convert_graphdef as ref_convert
from tensorflow_web_deploy_tpu.graphdef.proto import parse_graphdef as ref_parse
from tensorflow_web_deploy_tpu.ops import stem as jstem
from tensorflow_web_deploy_tpu.parallel.mesh import build_mesh
from tensorflow_web_deploy_tpu.serving.engine import InferenceEngine as JaxEngine
from tensorflow_web_deploy_tpu.utils import config as jcfg
from tensorflow_web_deploy_tpu_torch.graphdef import convert_graphdef, parse_graphdef
from tensorflow_web_deploy_tpu_torch.models.adapter import converted_graph
from tensorflow_web_deploy_tpu_torch.serving.engine import InferenceEngine
from tensorflow_web_deploy_tpu_torch.utils import config as tcfg
from tests.test_torch_converter import PREDICT_SCORE_TOL, lively_cls_pb  # noqa: F401
from tests.tf_golden import build_graph

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)


def _both(build):
    """(the port's ConvertedModel, the reference's) of one TF graph."""
    data = build_graph(build)
    return convert_graphdef(parse_graphdef(data)), ref_convert(ref_parse(data))


def _stem_conv(h, w, kk, strides=2, padding="VALID", pad=None, cout=8, cin=3, seed=0):
    k = np.random.RandomState(seed).randn(kk, kk, cin, cout).astype(np.float32)

    def build(tf):
        x = tf.compat.v1.placeholder(tf.float32, [None, h, w, 3], name="x")
        y = tf.pad(x, pad) if pad is not None else x
        y = tf.nn.conv2d(y, tf.constant(k), strides=[1, strides, strides, 1], padding=padding)
        tf.nn.relu(y, name="out")

    return build


CASES = {
    # Inception: a VALID stride-2 conv on the input, odd extent
    "valid_odd": (_stem_conv(75, 75, 3), (75, 75)),
    # MobileNet: ZeroPadding2D, then a VALID stride-2 conv
    "pad_valid": (_stem_conv(64, 64, 3, pad=[[0, 0], [0, 1], [0, 1], [0, 0]]), (64, 64)),
    "same_even_7x7": (_stem_conv(64, 64, 7, padding="SAME"), (64, 64)),
    # SAME 3×3 on 65: an even total pad per axis, so the gate accepts
    "same_odd": (_stem_conv(65, 65, 3, padding="SAME", cout=4), (65, 65)),
    # a Pad of odd total before a VALID conv on an odd extent: refused at 65
    "odd_pad_odd_extent": (_stem_conv(65, 65, 3, pad=[[0, 0], [0, 1], [0, 1], [0, 0]],
                                      cout=4), (65, 65)),
    # a Pad with odd leading amounts: the cells conv shifts the kernel
    "odd_leading_pad": (_stem_conv(64, 64, 3, pad=[[0, 0], [1, 2], [3, 0], [0, 0]]), (64, 64)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_stem_detected_as_the_reference_detects_it(case):
    build, (h, w) = CASES[case]
    port, ref = _both(build)
    assert port.s2d_stem is not None and ref.s2d_stem is not None
    ps, rs = port.s2d_stem, ref.s2d_stem
    assert (ps.conv_name, ps.skip_names, ps.base_pads, ps.conv_padding, ps.kernel_hw) == (
        rs.conv_name, rs.skip_names, rs.base_pads, rs.conv_padding, rs.kernel_hw)
    assert ps.cin == 3
    for size in ((h, w), (64, 64), (65, 65), (75, 75)):
        assert ps.resolve_pads(*size) == tuple(tuple(p) for p in rs.resolve_pads(*size))
        assert ps.supports(*size) is rs.supports(*size), size
    assert ps.supports(h, w) is (case != "odd_pad_odd_extent")


@pytest.mark.parametrize("case", sorted(c for c in CASES if c != "odd_pad_odd_extent"))
def test_cells_variant_equals_the_graph_and_the_reference(case):
    """``s2d_stem.build(h, w)`` on ``pack_s2d`` cells equals the unrewritten
    graph on the images and the reference's variant on the same cells
    (float32, 1e-5); the absorbed Pad runs no more, the stem's kernel was
    rearranged once at build, and the original module is unchanged."""
    build, (h, w) = CASES[case]
    port, ref = _both(build)
    x = np.random.RandomState(1).rand(2, h, w, 3).astype(np.float32)
    cells = np.asarray(jstem.pack_s2d(x))
    variant = port.s2d_stem.build(h, w)
    assert variant.cells_input and not port.cells_input
    assert variant.input_specs[0].shape == [None, (h + 1) // 2, (w + 1) // 2, 12]
    assert not set(port.s2d_stem.skip_names) & {n for n, _ in variant.call_nodes}
    assert any(layout == "s2d" for _, layout in variant.buffer_origin.values())
    with torch.no_grad():
        std = port(torch.from_numpy(x))[0].numpy()
        got = variant(torch.from_numpy(cells))[0].numpy()
    want = np.asarray(ref.s2d_stem.build(h, w)(ref.params, cells)[0])
    np.testing.assert_allclose(got, std, **TOL)
    np.testing.assert_allclose(got, want, **TOL)
    # converted_graph's s2d format and convert_graphdef(s2d_input=) build the same
    direct = convert_graphdef(parse_graphdef(build_graph(build)), s2d_input=(h, w))
    with torch.no_grad():
        np.testing.assert_array_equal(direct(torch.from_numpy(cells))[0].numpy(), got)


def test_refused_where_not_exact():
    build, _ = CASES["odd_pad_odd_extent"]
    port, _ = _both(build)
    with pytest.raises(ValueError, match="not exact"):
        port.s2d_stem.build(65, 65)
    with pytest.raises(ValueError, match="cannot take cells"):
        convert_graphdef(parse_graphdef(build_graph(build)), s2d_input=(65, 65))


def _no_rewrite_graphs():
    rs = np.random.RandomState(2)
    w1 = rs.randn(3, 3, 3, 8).astype(np.float32)
    w3 = rs.randn(3, 3, 3, 3).astype(np.float32)
    w32 = rs.randn(3, 3, 32, 8).astype(np.float32)

    def stride1(tf):
        x = tf.compat.v1.placeholder(tf.float32, [None, 32, 32, 3], name="x")
        tf.nn.conv2d(x, tf.constant(w1), strides=[1, 1, 1, 1], padding="SAME", name="out")

    def two_consumers(tf):
        x = tf.compat.v1.placeholder(tf.float32, [None, 32, 32, 3], name="x")
        a = tf.nn.conv2d(x, tf.constant(w3), strides=[1, 2, 2, 1], padding="SAME")
        tf.add(a, x[:, ::2, ::2], name="out")

    def fat_input(tf):
        x = tf.compat.v1.placeholder(tf.float32, [None, 16, 16, 32], name="x")
        tf.nn.conv2d(x, tf.constant(w32), strides=[1, 2, 2, 1], padding="SAME", name="out")

    return {"stride1": stride1, "two_consumers": two_consumers, "fat_input": fat_input}


@pytest.mark.parametrize("name", ["stride1", "two_consumers", "fat_input"])
def test_no_rewrite_for_wide_stride1_or_shared_input(name):
    port, ref = _both(_no_rewrite_graphs()[name])
    assert port.s2d_stem is None and ref.s2d_stem is None


def _cfg(mod, pb, wire, size=96, **kw):
    return mod.ServerConfig(
        model=mod.ModelConfig(name="small", source="pb", pb_path=pb, input_size=(size, size),
                              preprocess="inception", topk=5, dtype="float32"),
        canvas_buckets=(128,), max_batch=2, wire_format=wire, warmup=False, **kw)


def _keras_image():
    yy, xx = np.mgrid[0:120, 0:110].astype(np.float32)
    return np.stack([yy * 2, xx * 2, 240 - yy - xx], -1).clip(0, 255).astype(np.uint8)


def test_frozen_keras_graph_served_with_the_handshake(lively_cls_pb):
    """A frozen Keras MobileNetV2 (``lively_cls_pb``: He-normal constants,
    so its answers are not ties) on the yuv420 wire: the port's engine
    turns the handshake on (``s2d``, ``/stats``), as the reference's does,
    and answers as the reference's yuv420 engine does (every rank whose
    reference score stands apart by ``PREDICT_SCORE_TOL`` equal, scores
    within it). Its rgb engine takes no handshake. (The reference's test
    also holds the two wires within 0.05 of each other on the graph as
    frozen, whose answers are near-uniform; on the lively graph the 4:2:0
    chroma loss moves scores by more.)"""
    img = _keras_image()
    teng_y = InferenceEngine(_cfg(tcfg, lively_cls_pb, "yuv420"), device="cpu")
    teng_r = InferenceEngine(_cfg(tcfg, lively_cls_pb, "rgb"), device="cpu")
    jeng = JaxEngine(_cfg(jcfg, lively_cls_pb, "yuv420"), mesh=build_mesh(jax.devices()[:1]))
    try:
        assert teng_y.s2d and teng_y.stats()["s2d"] is True and jeng._s2d_handshake
        assert not teng_r.s2d and teng_r.stats()["s2d"] is False
        assert teng_y.model.graph.cells_input
        (ys, yi), (js, ji) = (
            e.run_batch(*[np.stack([a]) for a in e.prepare(img)]) for e in (teng_y, jeng))
        js = js[0]
        defined = [0] + [j for j in range(1, len(js) - 1)
                         if js[j - 1] - js[j] > PREDICT_SCORE_TOL
                         and js[j] - js[j + 1] > PREDICT_SCORE_TOL]
        assert [yi[0][j] for j in defined] == [ji[0][j] for j in defined]
        np.testing.assert_allclose(ys[0], js, atol=PREDICT_SCORE_TOL)
    finally:
        teng_y.close()
        teng_r.close()


@pytest.fixture(scope="module")
def gray_stem_pb(tmp_path_factory):
    """A classifier whose stem is a stride-2 conv over ONE channel: TF's
    grouped Conv2D of the 3-channel image (filter [3, 3, 1, 6], 3 groups),
    then a dense softmax head."""
    rs = np.random.RandomState(5)
    k = rs.randn(3, 3, 1, 6).astype(np.float32)
    dense = rs.randn(6, 4).astype(np.float32)

    def build(tf):
        x = tf.compat.v1.placeholder(tf.float32, [None, 32, 32, 3], name="input")
        y = tf.nn.relu(tf.nn.conv2d(x, tf.constant(k), strides=[1, 2, 2, 1], padding="SAME"))
        y = tf.reduce_mean(y, axis=[1, 2])
        tf.nn.softmax(tf.matmul(y, tf.constant(dense)), name="probs")

    path = tmp_path_factory.mktemp("gray") / "gray.pb"
    path.write_bytes(build_graph(build))
    return str(path)


def test_one_channel_stem_serves_without_the_handshake(gray_stem_pb):
    """The port's ``cin == 3`` gate (the reference's detector takes any
    ``cin`` ≤ 4, and its engine then hands 12 cell channels to a 4-channel
    kernel): the stem is found, with ``cin`` 1, and the yuv420 engine serves
    the graph on NHWC images, answering as the rgb engine does within the
    4:2:0 loss; asked for cells anyway, ``converted_graph`` builds a
    variant whose stem refuses them."""
    teng_y = InferenceEngine(_cfg(tcfg, gray_stem_pb, "yuv420", size=32), device="cpu")
    teng_r = InferenceEngine(_cfg(tcfg, gray_stem_pb, "rgb", size=32), device="cpu")
    try:
        stem = teng_y.model.graph.s2d_stem
        assert stem is not None and stem.cin == 1 and stem.supports(32, 32)
        assert teng_y.s2d is False and teng_y.stats()["s2d"] is False
        assert not teng_y.model.graph.cells_input
        img = _keras_image()
        out_y = teng_y.run_batch(*[np.stack([a]) for a in teng_y.prepare(img)])
        out_r = teng_r.run_batch(*[np.stack([a]) for a in teng_r.prepare(img)])
        assert np.isfinite(out_y[0]).all() and out_y[0].shape == (1, 4)
        np.testing.assert_allclose(out_y[0], out_r[0], atol=0.05)
    finally:
        teng_y.close()
        teng_r.close()
    model = converted_graph(_cfg(tcfg, gray_stem_pb, "yuv420", size=32).model,
                            input_format="s2d")
    with pytest.raises(ValueError, match="cin"):
        model(torch.zeros((1, 16, 16, 12)))
