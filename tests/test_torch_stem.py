"""The port's space-to-depth stem (ops/stem.py) and its handshake with the
yuv420 preprocess, against the JAX package on the CPU.

The same numpy inputs, made from a seed, go through the JAX function and
the port's: the stem convolutions (float32 within 1e-5, the bar the
reference's ``tests/test_stem.py`` sets against lax's conv), ``pack_s2d``
and ``worthwhile`` exactly, each zoo model built with
``input_format="s2d"`` on cells against its NHWC build and against the
JAX model (1e-4), the cell preprocess (the plain version of the cell
store, the plane resize that writes cells, ``make_preprocess_fn(s2d=True)``
on every resize), the engines' handshake on the yuv420 wire, and one
MobileNetV2 training step's gradients in float64. Small sizes throughout.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from flax.traverse_util import flatten_dict

from tensorflow_web_deploy_tpu import models as jax_models
from tensorflow_web_deploy_tpu.models.adapter import init_variables as jax_init
from tensorflow_web_deploy_tpu.ops import image as jimage
from tensorflow_web_deploy_tpu.ops import stem as jstem
from tensorflow_web_deploy_tpu.ops.pallas_preprocess import preprocess_i420 as jax_pp
from tensorflow_web_deploy_tpu.parallel.mesh import build_mesh
from tensorflow_web_deploy_tpu.serving.engine import InferenceEngine as JaxEngine
from tensorflow_web_deploy_tpu.utils import config as jcfg
from tensorflow_web_deploy_tpu_torch import models as torch_models
from tensorflow_web_deploy_tpu_torch.models.adapter import (
    from_jax_params,
    native_converted,
    to_jax_params,
)
from tensorflow_web_deploy_tpu_torch.models.common import ConvBN
from tensorflow_web_deploy_tpu_torch.ops import image as timage
from tensorflow_web_deploy_tpu_torch.ops import stem
from tensorflow_web_deploy_tpu_torch.ops.preprocess_i420 import (
    launch_shape,
    preprocess_i420,
    preprocess_i420_plain,
    preprocess_i420_wire,
)
from tensorflow_web_deploy_tpu_torch.serving.engine import InferenceEngine
from tensorflow_web_deploy_tpu_torch.utils import config as tcfg

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def _oihw(k: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(k)).permute(3, 2, 0, 1)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


# --------------------------------------------------------------- the stem


@pytest.mark.parametrize("padding", ["SAME", "VALID"])
@pytest.mark.parametrize("hw,kk", [(299, 3), (224, 7), (224, 3), (97, 3), (10, 3), (9, 5)])
def test_conv2d_stride2_s2d_matches_jax(hw, kk, padding):
    """The shapes and paddings of the reference's ``tests/test_stem.py``:
    the port's rewrite against the JAX package's and against the stock
    stride-2 conv with lax's pads."""
    rs = np.random.RandomState(hw * 10 + kk)
    x = rs.randn(2, hw, hw, 3).astype(np.float32)
    k = rs.randn(kk, kk, 3, 8).astype(np.float32)
    got = _nhwc(stem.conv2d_stride2_s2d(_nchw(x), _oihw(k), padding))
    want = np.asarray(jstem.conv2d_stride2_s2d(x, k, padding))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)
    pads = stem.stride2_pads((hw, hw), (kk, kk), padding)
    plain = _nhwc(stem.conv2d_padded(_nchw(x), _oihw(k), (2, 2), pads))
    np.testing.assert_allclose(got, plain, **TOL)


@pytest.mark.parametrize("pads", [((2, 1), (0, 3)), ((1, 2), (3, 0)), ((1, 1), (1, 1)),
                                  ((0, 0), (3, 3))])
@pytest.mark.parametrize("hw", [(30, 30), (37, 23)])
def test_explicit_and_odd_pads_match_jax(hw, pads):
    """Explicit pads, odd leading pads and a non-square input: the image
    rewrite and the cells rewrite (whose odd leading pads shift the kernel)
    against the JAX package's, float32 within 1e-5."""
    rs = np.random.RandomState(sum(hw))
    x = rs.randn(2, *hw, 3).astype(np.float32)
    k = rs.randn(3, 3, 3, 4).astype(np.float32)
    got = _nhwc(stem.conv2d_stride2_s2d(_nchw(x), _oihw(k), pads))
    np.testing.assert_allclose(got, np.asarray(jstem.conv2d_stride2_s2d(x, k, pads)), **TOL)
    cells = np.asarray(jstem.pack_s2d(x))
    got = _nhwc(stem.conv2d_s2d_input(_nchw(cells), _oihw(k), pads))
    want = np.asarray(jstem.conv2d_s2d_input(cells, k, pads))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)
    # the kernel built once equals the one built per call
    once = stem.s2d_input_kernel(_oihw(k), pads)
    np.testing.assert_array_equal(
        _nhwc(stem.conv2d_s2d_input(_nchw(cells), _oihw(k), pads, rearranged=once)), got)


@pytest.mark.parametrize("hw,c", [((8, 8), 3), ((9, 7), 3), ((5, 6), 1), ((299, 299), 3)])
def test_pack_s2d_equals_jax(hw, c):
    x = np.random.RandomState(hw[0]).randn(2, *hw, c).astype(np.float32)
    got = stem.pack_s2d(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jstem.pack_s2d(x)))


@pytest.mark.parametrize("padding", ["SAME", "VALID"])
@pytest.mark.parametrize("hw,kk", [(299, 3), (224, 7), (224, 3), (75, 3), (64, 5), (9, 1)])
def test_conv2d_s2d_input_matches_jax(hw, kk, padding):
    """The cells-consuming conv on ``pack_s2d`` cells, odd originals
    included, against the JAX package's."""
    rs = np.random.RandomState(hw + kk)
    x = rs.randn(2, hw, hw, 3).astype(np.float32)
    k = rs.randn(kk, kk, 3, 8).astype(np.float32)
    cells = np.asarray(jstem.pack_s2d(x))
    got = _nhwc(stem.conv2d_s2d_input(_nchw(cells), _oihw(k), padding))
    want = np.asarray(jstem.conv2d_s2d_input(cells, k, padding))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("cin,strides,kernel,dilation", [
    (3, (2, 2), (3, 3), (1, 1)), (3, (2, 2), (7, 7), (1, 1)), (4, (2, 2), (3, 3), (1, 1)),
    (5, (2, 2), (3, 3), (1, 1)), (3, (1, 1), (3, 3), (1, 1)), (3, (2, 2), (2, 2), (1, 1)),
    (3, (2, 2), (3, 3), (2, 2)), (1, (2, 2), (1, 1), (1, 1)), (3, (2, 1), (3, 3), (1, 1)),
])
def test_worthwhile_equals_jax(cin, strides, kernel, dilation):
    assert stem.worthwhile(cin, strides, kernel, dilation) is jstem.worthwhile(
        cin, strides, kernel, dilation)


def test_convbn_routes_and_keeps_the_logical_parameter():
    """A 3-channel stride-2 ConvBN takes the rewrite and declares the same
    ``conv.weight`` [cout, cin, kh, kw] as any conv; the fold builds the
    rearranged kernel once, outside the state dict, and the folded cell
    computes what the unfolded one does (float32, 1e-5)."""
    cell = ConvBN(3, 8, (3, 3), stride=2)
    assert cell.s2d == "fold" and cell.conv.weight.shape == (8, 3, 3, 3)
    assert ConvBN(3, 8, (3, 3), stride=1).s2d is None
    assert ConvBN(8, 8, (3, 3), stride=2).s2d is None
    with pytest.raises(ValueError, match="stride-2"):
        ConvBN(3, 8, (3, 3), s2d_input=True)
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 3, 17, 17).astype(np.float32))
    with torch.no_grad():
        want = cell(x)
        cell.fold()
        assert cell.stem_kernel.shape == (8, 12, 2, 2)
        assert not any("stem_kernel" in k for k in cell.state_dict())
        np.testing.assert_allclose(cell(x).numpy(), want.numpy(), **TOL)


# --------------------------------------------------------------- models

MODEL_SIZES = [("inception_v3", 75), ("mobilenet_v2", 64), ("resnet50", 64),
               ("ssd_mobilenet", 64)]


@pytest.mark.parametrize("name,size", MODEL_SIZES)
def test_model_on_cells_matches_nhwc_and_jax(name, size):
    """Each zoo model built with ``input_format="s2d"`` on ``pack_s2d``
    cells: equal to its NHWC build (both take the rewrite) and to the JAX
    model built the same way, on the same seeded weights (float32, 1e-4 of
    the output's scale)."""
    spec = jax_models.get(name)
    jmodel, variables = jax_init(spec, num_classes=8, width=0.25, seed=1)
    jcells = spec.build(num_classes=8, width=0.25, input_format="s2d")
    flat = {"/".join(k): np.asarray(v) for k, v in flatten_dict(variables).items()}
    x = np.random.RandomState(2).rand(2, size, size, 3).astype(np.float32)
    cells = np.asarray(jstem.pack_s2d(x))
    want = jax.tree.leaves(jcells.apply(variables, cells, train=False))
    tspec = torch_models.get(name)
    nhwc_model = tspec.build(num_classes=8, width=0.25)
    cells_model = tspec.build(num_classes=8, width=0.25, input_format="s2d")
    for m in (nhwc_model, cells_model):
        m.load_state_dict(from_jax_params(flat))
    stem_cell = cells_model.stem1 if name == "inception_v3" else cells_model.stem
    assert stem_cell.s2d == "input"
    with torch.no_grad():
        got = cells_model(_nchw(cells))
        std = nhwc_model(_nchw(x))
    got, std = (list(v) if isinstance(v, tuple) else [v] for v in (got, std))
    for g, s_, w in zip(got, std, want):
        w = np.asarray(w)
        atol = 1e-4 * max(1.0, np.abs(w).max())
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=atol, err_msg=name)
        np.testing.assert_allclose(g.numpy(), s_.numpy(), rtol=1e-4, atol=atol, err_msg=name)


def test_native_converted_s2d_checks():
    """``native_converted(input_format=...)`` refuses what the reference's
    adapter refuses: an unknown format, and cells for a SAME stem at an
    odd size; a VALID stem takes cells at any size."""
    with pytest.raises(ValueError, match="input_format"):
        native_converted("mobilenet_v2", width=0.25, num_classes=4, input_format="nchw")
    with pytest.raises(ValueError, match="even input size"):
        native_converted("mobilenet_v2", width=0.25, num_classes=4, input_size=65,
                         input_format="s2d")
    for name, ok in (("inception_v3", True), ("mobilenet_v2", False), ("resnet50", False),
                     ("ssd_mobilenet", False)):
        assert torch_models.get(name).s2d_ok(299, 299) is jax_models.get(name).s2d_ok(299, 299)
        assert torch_models.get(name).s2d_ok(299, 299) is ok
        assert torch_models.get(name).s2d_ok(224, 224)
    model = native_converted("inception_v3", width=0.25, num_classes=4, input_size=75,
                             input_format="s2d")
    assert model.backbone.stem1.stem_kernel.shape[1] == 12


# ------------------------------------------------------------ preprocess


def _i420_batch(seed: int, s: int = 64):
    rs = np.random.RandomState(seed)
    canv = rs.randint(0, 256, (2, s, s, 3)).astype(np.uint8)
    packed = np.stack([jimage.rgb_to_yuv420_canvas(c) for c in canv])
    return canv, packed, np.array([[s, s], [40, 56]], np.int32)


@pytest.mark.parametrize("mode", ["inception", "zero_one", "raw"])
@pytest.mark.parametrize("out", [31, 32, 75])
def test_plain_cell_preprocess_matches_pallas_packed(out, mode):
    """The cell store's plain version, through both entries, against the
    reference's ``pack_s2d(preprocess_i420(..., interpret=True))``: float32
    within 1e-5 (raw: 1e-3, values up to 255), odd extents' zero phases
    included; bf16 within one bf16 spacing of it."""
    _, packed, hws = _i420_batch(out)
    want = np.asarray(jstem.pack_s2d(jax_pp(packed, hws, out, out, mode, interpret=True)))
    tol = 1e-3 if mode == "raw" else 1e-5
    got = preprocess_i420(torch.from_numpy(packed), torch.from_numpy(hws), out, out, mode,
                          s2d=True)
    assert got.shape == (2, (out + 1) // 2, (out + 1) // 2, 12)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    buf = np.concatenate([packed.reshape(2, -1), hws.astype(">u2").view(np.uint8).reshape(2, 4)],
                         axis=1)
    wire = preprocess_i420_wire(torch.from_numpy(buf), 64, out, out, mode, s2d=True)
    assert torch.equal(wire, got)
    bf16 = preprocess_i420_plain(torch.from_numpy(packed), torch.from_numpy(hws), out, out,
                                 mode, torch.bfloat16, s2d=True).float().numpy()
    spacing = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126))) - 7)
    assert np.all(np.abs(bf16 - want) <= spacing + tol)
    if out % 2:  # the phase an odd extent lacks is zero
        assert not got[:, -1, :, 6:].any() and not got[:, :, -1, 3:6].any()


def test_cell_launch_rule_keeps_bands_even():
    """The cell store's bands are an even number of rows (each band whole
    cell rows); its shared memory fits the kernel's limit at every canvas
    side the engine ships."""
    from tensorflow_web_deploy_tpu_torch.ops import preprocess_i420 as pp

    for b in (1, 8, 32, 256):
        for s in (256, 512, 1024, 2048):
            for out in (224, 299, 300):
                for elt in (2, 4):
                    shape = launch_shape(b, s, out, out, elt, 132, s2d=True)
                    assert shape.rows % 2 == 0 and shape.rows >= 2
                    assert shape.smem(s, out, elt, s2d=True) <= pp.MAX_SMEM
                    nhwc = launch_shape(b, s, out, out, elt, 132)
                    assert shape.rows == max(2, nhwc.rows) or shape.rows >= nhwc.rows


@pytest.mark.parametrize("out,valid", [(31, 40), (32, 64), (75, 17), (64, 1)])
def test_sampling_matrices_equal_jax(out, valid):
    """The chroma fold, the (cell, phase) regrouping and the packed-chroma
    split of the sampling matrices, bit for bit the reference's; the split
    applied to the wire's packed chroma rows equals the folded matrix on
    the plane."""
    s = 64
    a = jimage._bilinear_matrix(out, jnp.asarray(valid), s)
    ta = timage._bilinear_matrix(out, torch.tensor([valid]), s)
    np.testing.assert_array_equal(ta[0].numpy(), np.asarray(a))
    np.testing.assert_array_equal(timage._fold_chroma(ta)[0].numpy(),
                                  np.asarray(jimage._fold_chroma(a)))
    np.testing.assert_array_equal(timage._s2d_pair(ta, out)[0].numpy(),
                                  np.asarray(jimage._s2d_pair(a, out)))
    even, odd = timage._bilinear_matrix_chroma_packed(out, torch.tensor([valid]), s)
    for got, want in zip((even, odd), jimage._bilinear_matrix_chroma_packed(
            out, jnp.asarray(valid), s)):
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))
    plane = torch.from_numpy(np.random.RandomState(out).rand(s // 2, s // 2).astype(np.float32))
    rows = plane.reshape(s // 4, s)  # the wire's layout: plane rows 2k, 2k + 1 side by side
    packed = even[0] @ rows[:, : s // 2] + odd[0] @ rows[:, s // 2:]
    np.testing.assert_allclose(packed.numpy(), (timage._fold_chroma(ta)[0] @ plane).numpy(),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mode", ["inception", "zero_one", "caffe", "raw"])
@pytest.mark.parametrize("out", [31, 32])
def test_resize_yuv_planes_s2d_matches_jax(out, mode):
    _, packed, hws = _i420_batch(out + 7)
    want = np.stack([np.asarray(jimage.resize_yuv_planes_s2d(p, hw, out, out, mode))
                     for p, hw in zip(packed, hws)])
    got = timage.resize_yuv_planes_s2d(torch.from_numpy(packed), torch.from_numpy(hws), out,
                                       out, mode)
    tol = 1e-5 if mode in ("inception", "zero_one") else 1e-3
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    std = timage.make_preprocess_fn(out, out, mode, wire="yuv420")(
        torch.from_numpy(packed), torch.from_numpy(hws))
    np.testing.assert_allclose(got.numpy(), stem.pack_s2d(std).numpy(), rtol=0, atol=tol)


@pytest.mark.parametrize("wire,resize,mode,out", [
    ("yuv420", "matmul", "inception", 32), ("yuv420", "matmul", "caffe", 31),
    ("yuv420", "gather", "inception", 31), ("yuv420", "kernel", "zero_one", 31),
    ("rgb", "matmul", "caffe", 31), ("rgb", "gather", "inception", 32),
])
def test_make_preprocess_fn_s2d_matches_jax(wire, resize, mode, out):
    """``make_preprocess_fn(s2d=True)`` on every resize against the JAX
    package's (its kernel path: the Pallas kernel interpreted, then
    ``pack_s2d``), and against ``pack_s2d`` of the port's own NHWC output."""
    canv, packed, hws = _i420_batch(3)
    x = packed if wire == "yuv420" else canv
    if resize == "kernel":
        want = np.asarray(jstem.pack_s2d(jax_pp(packed, hws, out, out, mode, interpret=True)))
    else:
        want = np.asarray(jax.jit(jimage.make_preprocess_fn(out, out, mode, wire=wire,
                                                            resize=resize, s2d=True))(x, hws))
    fn = timage.make_preprocess_fn(out, out, mode, wire=wire, resize=resize, s2d=True)
    got = fn(torch.from_numpy(x), torch.from_numpy(hws))
    tol = 1e-5 if mode in ("inception", "zero_one") else 1e-3
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    std = timage.make_preprocess_fn(out, out, mode, wire=wire, resize=resize)(
        torch.from_numpy(x), torch.from_numpy(hws))
    np.testing.assert_allclose(got.numpy(), stem.pack_s2d(std).numpy(), rtol=0, atol=tol)


# --------------------------------------------------------------- engines

MOBILENET = dict(name="mobilenet_v2", source="native", zoo_width=0.25, zoo_classes=9,
                 input_size=(64, 64), preprocess="inception", topk=3, dtype="float32")
INCEPTION = {**MOBILENET, "name": "inception_v3", "input_size": (75, 75)}


def _images(seed):
    rs = np.random.RandomState(seed)
    out = []
    for h, w in [(80, 72), (50, 90), (96, 96)]:
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        img = np.stack([yy * 2, xx * 2, 200 - yy - xx], -1) + rs.normal(0, 20, (h, w, 3))
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return out


@pytest.mark.parametrize("jax_resize,port_resize,model", [
    pytest.param("matmul", "matmul", MOBILENET, id="matmul-mobilenet_v2"),
    pytest.param("gather", "gather", MOBILENET, id="gather-mobilenet_v2"),
    pytest.param("pallas", "kernel", MOBILENET, id="kernel-mobilenet_v2"),
    pytest.param("matmul", "matmul", INCEPTION, id="matmul-inception_v3"),
    pytest.param("gather", "gather", INCEPTION, id="gather-inception_v3"),
])
def test_engine_handshake_matches_jax(jax_resize, port_resize, model):
    """On the yuv420 wire both engines turn the handshake on (the port's
    ``s2d`` and ``/stats``, the reference's ``_s2d_handshake``), their
    preprocess stages give the same cells, and their answers agree: top-k
    indices equal, scores within 1e-4 (float32, the same seeded weights)."""
    common = dict(canvas_buckets=(96,), max_batch=4, wire_format="yuv420", warmup=False)
    jeng = JaxEngine(jcfg.ServerConfig(model=jcfg.ModelConfig(**model), resize=jax_resize,
                                       **common), mesh=build_mesh(jax.devices()[:1]))
    teng = InferenceEngine(tcfg.ServerConfig(model=tcfg.ModelConfig(**model),
                                             resize=port_resize, **common), device="cpu")
    try:
        assert jeng._s2d_handshake and teng.s2d and teng.stats()["s2d"] is True
        prepared = [teng.prepare(img) for img in _images(0)]
        canvases = np.stack([c for c, _ in prepared])
        hws = np.array([hw for _, hw in prepared], np.int32)
        h, w = model["input_size"]
        x = teng.preprocess_packed(torch.from_numpy(np.concatenate(
            [canvases.reshape(3, -1), hws.astype(">u2").view(np.uint8).reshape(3, 4)], 1)))
        assert x.shape == (3, (h + 1) // 2, (w + 1) // 2, 12)
        j_scores, j_idx = jeng.run_batch(canvases, hws)
        t_scores, t_idx = teng.run_batch(canvases, hws)
        np.testing.assert_array_equal(t_idx, j_idx)
        np.testing.assert_allclose(t_scores, j_scores, atol=1e-4)
    finally:
        teng.close()


def test_engine_handshake_only_on_the_yuv420_wire_and_exact_sizes():
    """The switch is the reference's: the rgb wire (ragged or not) never
    hands cells; a SAME stem at an odd size does not either; the int8
    gate's probe and its float32 reference take cells on a handshake
    engine, as the reference's do, and reach its verdict."""
    def mk(**kw):
        model = {**MOBILENET, **kw.pop("model", {})}
        cfg = tcfg.ServerConfig(model=tcfg.ModelConfig(**model), canvas_buckets=(96,),
                                max_batch=4, warmup=False, **kw)
        return InferenceEngine(cfg, device="cpu"), JaxEngine(
            jcfg.ServerConfig(model=jcfg.ModelConfig(**model), canvas_buckets=(96,),
                              max_batch=4, warmup=False, **kw),
            mesh=build_mesh(jax.devices()[:1]))

    for kw, want in [(dict(wire_format="rgb"), False),
                     (dict(wire_format="rgb", ragged=True), False),
                     (dict(wire_format="yuv420", model={"input_size": (65, 65)}), False),
                     (dict(wire_format="yuv420", model={"dtype": "int8"}), True)]:
        teng, jeng = mk(**kw)
        try:
            assert teng.s2d is want and teng.stats()["s2d"] is want
            assert jeng._s2d_handshake is want
            if teng.parity is not None:
                assert teng.parity["pass"] is jeng.parity["pass"] is True
                assert teng.parity["topk_agreement"] == jeng.parity["topk_agreement"]
        finally:
            teng.close()


# ---------------------------------------------------------------- training


@contextlib.contextmanager
def _x64():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", prev)


def test_train_step_gradients_match_jax_float64():
    """One MobileNetV2 training step's gradients (BN on batch statistics,
    mean cross-entropy): the stem's kernel is rearranged from the parameter
    on the step and autograd flows through it. Every parameter's gradient
    against ``jax.grad`` of the reference's loss, float64, rtol 1e-9 and an
    atol of 1e-12 of the largest gradient."""
    spec = jax_models.get("mobilenet_v2")
    model, variables = jax_init(spec, num_classes=4, width=0.25, seed=3)
    rs = np.random.RandomState(0)
    x = rs.rand(8, 32, 32, 3)
    y = rs.randint(0, 4, 8).astype(np.int32)
    with _x64():
        v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)

        def loss_fn(params):
            logits, _ = model.apply({"params": params, "batch_stats": v64["batch_stats"]},
                                    jnp.asarray(x), train=True, mutable=["batch_stats"])
            return optax.softmax_cross_entropy_with_integer_labels(logits, jnp.asarray(y)).mean()

        grads = jax.grad(loss_fn)(v64["params"])
        want = {f"params/{'/'.join(k)}": np.asarray(v) for k, v in flatten_dict(grads).items()}
    module = torch_models.get("mobilenet_v2").build(num_classes=4, width=0.25).double()
    flat = {"/".join(k): np.asarray(v) for k, v in flatten_dict(variables).items()}
    module.load_state_dict(from_jax_params(flat))
    assert module.stem.s2d == "fold" and module.stem.stem_kernel is None
    module.train()
    loss = F.cross_entropy(module(_nchw(x)), torch.from_numpy(y).long())
    loss.backward()
    # the gradients in the JAX layout, by the parameters' names
    for p in module.parameters():
        p.data = p.grad
    got = {k: v for k, v in to_jax_params(module).items() if k.startswith("params/")}
    assert sorted(got) == sorted(want)
    scale = max(np.abs(v).max() for v in want.values())
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-9, atol=1e-12 * scale, err_msg=k)
    assert np.abs(want["params/stem/conv/kernel"]).max() > 0
