"""The port's int8 tier (ops/quant.py, models/adapter.py::quantize_int8,
the engine's parity gate) against the JAX package's, on the CPU.

- the port's own copy of the quant functions gives bit for bit the JAX
  package's int8 kernels and scales on the seeded MobileNetV2 params;
- dequantization follows ``dequantize_tree``: q and scale each cast to
  bf16, then multiplied (bit-identical products);
- the port's int8 engine passes its golden parity gate with the
  reference's tolerances, and agrees with the JAX int8 engine on the same
  canvases (margin-aware top-k agreement ≥ 0.90 at 0.15). Both quantize
  the same kernels identically, but the JAX engine applies BN in bf16 after
  a bf16 dequant while the port folds BN's scale into the float32 dequant
  scale, so their bf16 roundings differ; 0.15 is the reference's own int8
  tolerance against float32, and each side sits within it of float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_web_deploy_tpu.models.adapter import native_converted as jax_native
from tensorflow_web_deploy_tpu.ops import quant as jquant
from tensorflow_web_deploy_tpu.parallel.mesh import build_mesh
from tensorflow_web_deploy_tpu.serving.engine import InferenceEngine as JaxEngine
from tensorflow_web_deploy_tpu.utils import config as jcfg
from tensorflow_web_deploy_tpu_torch.models.adapter import native_converted
from tensorflow_web_deploy_tpu_torch.models.common import DepthwiseConvBN
from tensorflow_web_deploy_tpu_torch.ops import quant
from tensorflow_web_deploy_tpu_torch.serving.engine import InferenceEngine
from tensorflow_web_deploy_tpu_torch.utils import config as tcfg

torch.set_num_threads(2)

SIZE, CLASSES = 64, 8
# the reference engine's int8 gate (serving/engine.py _PARITY_TOL["int8"])
INT8_PROB, INT8_TOPK = 0.15, 0.90


def _model_cfg(mod, dtype, **kw):
    return mod.ModelConfig(name="mobilenet_v2", source="native", zoo_width=0.25,
                           zoo_classes=CLASSES, input_size=(SIZE, SIZE), dtype=dtype, **kw)


def _port_engine(dtype, **kw):
    cfg = tcfg.ServerConfig(model=_model_cfg(tcfg, dtype, **kw), canvas_buckets=(SIZE,),
                            max_batch=8, warmup=False)
    return InferenceEngine(cfg, device="cpu")


@pytest.fixture(scope="module")
def seeded_params():
    return {k: np.asarray(v) for k, v in
            jax_native("mobilenet_v2", num_classes=CLASSES, width=0.25, seed=0).params.items()}


def test_quantized_params_bit_identical_to_jax(seeded_params):
    want = jquant.quantize_params(seeded_params, np.float32)
    got = quant.quantize_params(seeded_params, np.float32)
    assert sorted(got) == sorted(want)
    n_q = 0
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        n_q += got[k].dtype == np.int8
    # stem, 16 expand, 17 depthwise, 17 project, head, logits
    assert n_q == 53
    rs = np.random.RandomState(1)
    w = (rs.randn(3, 3, 1, 16) * np.geomspace(0.01, 10.0, 16)).astype(np.float32)
    w[..., 3] = 0  # a dead channel: scale 1.0
    for a, b in zip(quant.quantize_leaf(w), jquant.quantize_leaf(w)):
        np.testing.assert_array_equal(a, b)
    for key, v in [("b/conv/kernel", w), ("bn/scale", w[0, 0, 0]), ("d/kernel", w[0, 0]),
                   ("k/kernel" + quant.QSCALE_SUFFIX, w), ("h/weights", w.astype(np.float16))]:
        assert quant.quantizable(key, v) == jquant.quantizable(key, v), key
    ref, q = rs.rand(6, CLASSES).astype(np.float32), rs.rand(6, CLASSES).astype(np.float32)
    for k, tol in [(1, 0.0), (3, 0.05), (5, 0.2)]:
        assert quant.topk_agreement(ref, q, k, tol) == jquant.topk_agreement(ref, q, k, tol)


def test_dequantize_follows_the_reference_rule(seeded_params):
    key = "params/block2_1/dw/dwconv/kernel"
    qp = jquant.quantize_params({key: seeded_params[key]}, np.float32)
    want = np.asarray(jquant.dequantize_tree(qp, jnp.bfloat16)[key], np.float32)  # HWIO
    q = torch.from_numpy(np.ascontiguousarray(qp[key].transpose(3, 2, 0, 1)))
    scale = torch.from_numpy(qp[key + quant.QSCALE_SUFFIX]).to(torch.bfloat16)
    got = quant.dequantize(q, scale)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy().transpose(2, 3, 1, 0), want)


def test_int8_module_keeps_int8_weights(seeded_params):
    model = native_converted("mobilenet_v2", num_classes=CLASSES, width=0.25,
                             params_flat=seeded_params, fused_dw=True, int8=True)
    model = model.to(torch.bfloat16)
    int8 = [b for n, b in model.named_buffers() if n.endswith(".q")]
    assert len(int8) == 53 and all(b.dtype == torch.int8 for b in int8)
    floats = [p for p in model.parameters()] + [
        b for n, b in model.named_buffers() if not n.endswith((".q", ".tap_bias", ".stem_kernel"))]
    assert all(t.dtype == torch.bfloat16 and t.dim() == 1 for t in floats)
    # the space-to-depth stem keeps its q rearranged once, int8 too
    stem = model.backbone.stem
    assert stem.stem_kernel.dtype == torch.int8 and stem.stem_kernel.shape[1:] == (12, 2, 2)
    # the fused cells keep their bias float32, rounded as the cast rounds the
    # conv's, and no float taps: they dequantize into that layout per call
    dw = [m for m in model.modules() if isinstance(m, DepthwiseConvBN)]
    assert len(dw) == 17 and all(m.taps is None and m.tap_bias.dtype == torch.float32
                                 for m in dw)
    cell = model.backbone.block2_1.dw
    torch.testing.assert_close(cell.tap_bias[0], cell.dwconv.bias.float(), rtol=0, atol=0)
    got = quant.dequantize_taps(cell.dwconv.q, cell.dwconv.scale)
    want = quant.dequantize(cell.dwconv.q, cell.dwconv.scale).float()
    torch.testing.assert_close(got, want.reshape(want.shape[0], -1).t(), rtol=0, atol=0)
    qp = quant.quantize_params(seeded_params)
    q = model.backbone.block2_1.dw.dwconv.q
    np.testing.assert_array_equal(q.numpy().transpose(2, 3, 1, 0),
                                  qp["params/block2_1/dw/dwconv/kernel"])


@pytest.mark.parametrize("size", [64, 65])
@pytest.mark.parametrize("fused", [False, True])
def test_int8_forward_in_float32_matches_jax_dequantized(seeded_params, size, fused):
    """The int8 model's arithmetic, held tightly: left in float32, the port
    dequantizes q·(scale·s) with BN's shift as the bias; the JAX model gets
    the same q dequantized to float32 (q·scale) and applies BN itself. On
    perturbed BN statistics the two differ only by float32 rounding."""
    rs = np.random.RandomState(size)
    params = dict(seeded_params)
    for k, v in params.items():
        if k.endswith(("/mean", "/bias")):
            params[k] = rs.normal(0, 0.1, v.shape).astype(np.float32)
        elif k.endswith(("/var", "/scale")):
            params[k] = rs.uniform(0.5, 1.5, v.shape).astype(np.float32)
    x = rs.uniform(-1, 1, (3, size, size, 3)).astype(np.float32)
    ref = jax_native("mobilenet_v2", num_classes=CLASSES, width=0.25, seed=0, input_size=size)
    dq = jquant.dequantize_tree(jquant.quantize_params(params, np.float32), jnp.float32)
    want = np.asarray(jax.jit(ref.fn)(dq, x)[0])
    model = native_converted("mobilenet_v2", num_classes=CLASSES, width=0.25,
                             params_flat=params, fused_dw=fused, int8=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == (3, CLASSES)
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_int8_engine_parity_gate_passes():
    eng = _port_engine("int8")
    try:
        p = eng.parity
        assert p is not None and p["pass"], p
        assert (p["tol_prob"], p["tol_topk"]) == (INT8_PROB, INT8_TOPK)
        assert p["topk_agreement"] >= INT8_TOPK and p["max_prob_delta"] <= INT8_PROB
        assert eng.fused_dw and p["fused_dw"]  # "auto" fuses the int8 tier
        st = eng.stats()
        assert st["parity"] == p and st["fused_dw"] is True
        assert st["kernel_launches"]["fused_dw"] == 0  # the CPU runs the plain version
    finally:
        eng.close()


def test_int8_engine_agrees_with_jax_int8_engine():
    jmc = _model_cfg(jcfg, "int8", topk=CLASSES)
    jeng = JaxEngine(jcfg.ServerConfig(model=jmc, canvas_buckets=(SIZE,), max_batch=8,
                                       warmup=False), mesh=build_mesh(jax.devices()[:1]))
    teng = _port_engine("int8", topk=CLASSES)
    try:
        assert jeng.parity["pass"] and teng.parity["pass"]
        rs = np.random.RandomState(4)
        canvases = (rs.rand(8, SIZE, SIZE, 3) * 255).astype(np.uint8)
        hws = np.full((8, 2), SIZE, np.int32)

        def full_probs(scores, idx):  # topk = every class: rebuild the vector
            out = np.zeros((len(idx), CLASSES), np.float32)
            np.put_along_axis(out, idx, scores, axis=1)
            return out

        want = full_probs(*jeng.run_batch(canvases, hws))
        got = full_probs(*teng.run_batch(canvases, hws))
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got.sum(1), 1.0, atol=2e-2)  # bf16 softmax
        assert quant.topk_agreement(want, got, 5, INT8_PROB) >= INT8_TOPK
        assert float(np.abs(got - want).max()) <= INT8_PROB
    finally:
        jeng.close()
        teng.close()


def test_fused_dw_knob_and_bf16_gate_on_demand():
    """bf16 builds ungated and unfused; its gate answers on demand within
    the reference's bf16 tolerance; fused_dw="on" forces the fused cells
    and "off" keeps int8 unfused."""
    eng = _port_engine("bfloat16")
    try:
        assert eng.parity is None and eng.fused_dw is False
        p = eng.parity_check(batch=2)
        assert p["pass"] and p["tol_prob"] == 0.08, p
    finally:
        eng.close()
    for dtype, knob, want in [("bfloat16", "on", True), ("int8", "off", False),
                              ("float32", "auto", False)]:
        assert _model_cfg(tcfg, dtype, fused_dw=knob).fuse_depthwise is want
    forced = _port_engine("int8", fused_dw="off")
    try:
        assert forced.fused_dw is False and forced.parity["pass"]
    finally:
        forced.close()
