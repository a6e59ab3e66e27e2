"""The port's ResNet-50 (models/resnet50.py) against the JAX package's flax
model and engine, on the CPU: seeded init leaf by leaf, weight carry-over,
float32 probabilities at 64 and 65 px, the BN fold, the "SAME" max pool
against flax's bit for bit, the int8 tier's quantized weights and its
parity-gate verdict, engine top-k on the ragged rgb wire (matmul, gather)
and on yuv420 (matmul), the refusal of the preprocess kernel for caffe, the
cost model's walker against the module, and a served model beside a
full-width int8 load that the gate refuses. Small size: width 0.25, 10
classes, except where the gate's verdict needs the reference's width.

"SAME" padding is lax's everywhere: the 7×7 stride-2 stem pads (2, 3) on
an even input and (3, 3) on an odd one, the stride-2 max pool and 3×3
convs (0, 1) and (1, 1). The probability checks at 64 and 65 px pin them.
Every BN has ε = 1e-5; with the zoo's 1e-3 the f32 check fails.
"""

import copy
import io
import json
import math
import urllib.error
import urllib.request

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax.traverse_util import flatten_dict, unflatten_dict
from PIL import Image

from tensorflow_web_deploy_tpu.models import get as jax_get
from tensorflow_web_deploy_tpu.models.adapter import init_variables as jax_init
from tensorflow_web_deploy_tpu.models.adapter import native_converted as jax_native
from tensorflow_web_deploy_tpu.ops import quant as jquant
from tensorflow_web_deploy_tpu.ops import stem as jstem
from tensorflow_web_deploy_tpu.parallel.mesh import build_mesh
from tensorflow_web_deploy_tpu.serving.engine import InferenceEngine as JaxEngine
from tensorflow_web_deploy_tpu.utils import config as jcfg
from tensorflow_web_deploy_tpu_torch.models import get as torch_get
from tensorflow_web_deploy_tpu_torch.models.adapter import (
    from_jax_params,
    init_variables,
    native_converted,
    quantize_int8,
    to_jax_params,
)
from tensorflow_web_deploy_tpu_torch.models.common import BatchNorm, fold_bn, max_pool_same
from tensorflow_web_deploy_tpu_torch.models import resnet50 as resnet50_module
from tensorflow_web_deploy_tpu_torch.models.resnet50 import ResNet50
from tensorflow_web_deploy_tpu_torch.ops import quant
from tensorflow_web_deploy_tpu_torch.ops.image import pad_to_canvas
from tensorflow_web_deploy_tpu_torch.ops.quant import Int8Conv2d, Int8Linear
from tensorflow_web_deploy_tpu_torch.server import start_server
from tensorflow_web_deploy_tpu_torch.serving import costmodel
from tensorflow_web_deploy_tpu_torch.serving.engine import InferenceEngine
from tensorflow_web_deploy_tpu_torch.utils import config as tcfg

torch.set_num_threads(2)

WIDTH, CLASSES = 0.25, 10
# 53 convs (stem, 16 blocks × 3, 4 downsamples) × (kernel + 4 BN leaves) + dense
LEAVES = 53 * 5 + 2
MODEL = dict(name="resnet50", source="native", zoo_width=WIDTH, zoo_classes=CLASSES,
             input_size=(64, 64), preprocess="caffe", topk=3, dtype="float32")
CANVAS = 96


@pytest.fixture(scope="module")
def jax_model():
    return jax_native("resnet50", num_classes=CLASSES, width=WIDTH, seed=0, input_size=64)


def _perturbed_bn(params, seed):
    """Non-trivial BN statistics, so that the fold and ε are exercised."""
    rs = np.random.RandomState(seed)
    params = {k: np.asarray(v) for k, v in params.items()}
    for k in params:
        if k.endswith("/mean") or k.endswith("/bias"):
            params[k] = rs.normal(0, 0.1, params[k].shape).astype(np.float32)
        elif k.endswith("/var") or k.endswith("/scale"):
            params[k] = rs.uniform(0.5, 1.5, params[k].shape).astype(np.float32)
    return params


def _unsaturated(params, scale):
    """``params`` with the dense kernel scaled by ``scale``. The seeded
    network's logits are large (He init and no zero-init residual), so its
    softmax is one-hot and the other classes tie at 0.0
    (:func:`test_seeded_softmax_is_one_hot`), where a probability check or
    a top-k order tests nothing. Scaled, the logits are a few units."""
    params = dict(params)
    params["params/logits/kernel"] = np.asarray(params["params/logits/kernel"]) * np.float32(scale)
    return params


@pytest.mark.parametrize("low,high", [(-1.0, 1.0), (-124.0, 152.0)], ids=["unit", "caffe"])
def test_seeded_softmax_is_one_hot(low, high):
    x = np.random.RandomState(1).uniform(low, high, (3, 64, 64, 3)).astype(np.float32)
    model = native_converted("resnet50", num_classes=CLASSES, width=WIDTH)
    with torch.no_grad():
        logits = model.backbone(torch.from_numpy(x).permute(0, 3, 1, 2))
    probs = logits.softmax(-1)
    assert float(logits.std(1).min()) > 100.0 and probs.max(1).values.min() > 0.98
    assert bool(((probs == 0).sum(1) >= 2).all())  # every image has classes tied at 0.0


def test_seeded_init_equals_jax_leaf_by_leaf():
    _, variables = jax_init(jax_get("resnet50"), num_classes=CLASSES, width=WIDTH, seed=0)
    want = {"/".join(k): np.asarray(v) for k, v in flatten_dict(variables).items()}
    module, got = init_variables(torch_get("resnet50"), num_classes=CLASSES, width=WIDTH, seed=0)
    assert sorted(got) == sorted(want) and len(got) == LEAVES
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    back = to_jax_params(module)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)


def test_from_jax_params_carries_weights(jax_model):
    rs = np.random.RandomState(3)
    params = {k: (np.asarray(v) + rs.normal(0, 0.01, np.shape(v))).astype(np.float32)
              for k, v in jax_model.params.items()}
    state = from_jax_params(params)
    module = torch_get("resnet50").build(num_classes=CLASSES, width=WIDTH)
    module.load_state_dict(state)  # strict: every key present, no extras
    back = to_jax_params(module)
    assert sorted(back) == sorted(params)
    for k in params:
        np.testing.assert_array_equal(back[k], params[k], err_msg=k)
    # HWIO [7, 7, 3, 16] → OIHW; stage 0's first block projects 16 → 64 at
    # stride 1, every other stage's first block at stride 2, no other block
    assert tuple(state["stem.conv.weight"].shape) == (16, 3, 7, 7)
    assert tuple(state["stage0_0.downsample.conv.weight"].shape) == (64, 16, 1, 1)
    assert [n for n in module.block_names if module.get_submodule(n).downsample is not None] \
        == ["stage0_0", "stage1_0", "stage2_0", "stage3_0"]
    assert [module.get_submodule(n).conv2.stride for n in module.block_names
            if n.endswith("_0")] == [1, 2, 2, 2]
    assert module.logits.out_features == CLASSES


def test_every_bn_has_the_resnet_eps():
    module = ResNet50(num_classes=CLASSES, width=WIDTH)
    eps = [m.eps for m in module.modules() if isinstance(m, BatchNorm)]
    assert len(eps) == 53 and set(eps) == {1e-5}


@pytest.mark.parametrize("size", [64, 65])
def test_f32_probabilities_match_jax(jax_model, size):
    params = _unsaturated(_perturbed_bn(jax_model.params, size), 1e-3)
    x = np.random.RandomState(size).uniform(-1, 1, (3, size, size, 3)).astype(np.float32)
    ref = jax_native("resnet50", num_classes=CLASSES, width=WIDTH, seed=0, input_size=size)
    want = np.asarray(jax.jit(ref.fn)(params, x)[0])
    model = native_converted("resnet50", num_classes=CLASSES, width=WIDTH, params_flat=params)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == (3, CLASSES) and want.min() > 1e-8  # no class ties at 0
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_bn_fold_is_exact(jax_model):
    module = torch_get("resnet50").build(num_classes=CLASSES, width=WIDTH)
    module.load_state_dict(from_jax_params(_unsaturated(_perturbed_bn(jax_model.params, 5),
                                                        1e-3)))
    module.eval()
    x = torch.from_numpy(np.random.RandomState(7).uniform(-1, 1, (3, 3, 65, 65))
                         .astype(np.float32))
    with torch.no_grad():
        before = module(x)
        after = fold_bn(module)(x)
    assert not any(isinstance(m, BatchNorm) for m in module.modules())
    assert module.stage0_0.downsample.conv.bias is not None
    # exact up to float rounding, which 16 blocks accumulate: no logit moves
    # by more than 1e-5 of the largest, no probability by more than 1e-5
    assert float((after - before).abs().max()) <= 1e-5 * float(before.abs().max())
    torch.testing.assert_close(after.softmax(-1), before.softmax(-1), atol=1e-5, rtol=0)


@pytest.mark.parametrize("size", [32, 33])
@pytest.mark.parametrize("shift", [0.0, -10.0], ids=["mixed", "all_negative"])
def test_max_pool_same_is_flax_bit_for_bit(size, shift):
    """All-negative inputs: a pad of 0 would win at the border, −inf never does."""
    x = (np.random.RandomState(size).uniform(-1, 1, (2, size, size, 5)) + shift) \
        .astype(np.float32)
    want = np.asarray(fnn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2), padding="SAME"))
    got = max_pool_same(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, -(-size // 2), -(-size // 2), 5)
    np.testing.assert_array_equal(got, want)
    # bf16 keeps the −inf pad: the max of bf16 inputs is one of them
    got16 = max_pool_same(torch.from_numpy(x).permute(0, 3, 1, 2).bfloat16())
    np.testing.assert_array_equal(got16.float().permute(0, 2, 3, 1).numpy(),
                                  torch.from_numpy(want.copy()).bfloat16().float().numpy())
    # padding=1 pads (1, 1): on an even input every window moves
    sym = F.max_pool2d(torch.from_numpy(x).permute(0, 3, 1, 2), 3, 2, padding=1)
    assert np.array_equal(sym.permute(0, 2, 3, 1).numpy(), want) == (size % 2 == 1)


def test_int8_weights_bit_identical_to_the_reference(jax_model):
    params = {k: np.asarray(v) for k, v in jax_model.params.items()}
    want = jquant.quantize_params(params, np.float32)
    got = quant.quantize_params(params, np.float32)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert sum(v.dtype == np.int8 for v in got.values()) == 54  # 53 convs + dense
    # the served module keeps the reference's q, OIHW, and its scale × BN s
    module = torch_get("resnet50").build(num_classes=CLASSES, width=WIDTH)
    module.load_state_dict(from_jax_params(params))
    quantize_int8(module, params)
    convs = {n: m for n, m in module.named_modules() if isinstance(m, Int8Conv2d)}
    assert len(convs) == 53 and isinstance(module.logits, Int8Linear)
    for name, m in convs.items():
        key = "params/" + name.replace(".", "/").rsplit("/", 1)[0] + "/conv/kernel"
        np.testing.assert_array_equal(m.q.numpy().transpose(2, 3, 1, 0), want[key],
                                      err_msg=name)
    np.testing.assert_array_equal(module.logits.q.numpy().T, want["params/logits/kernel"])


def _gate_cfg(mod, width, size=64):
    """The reference's int8 tier at ``width``, 1000 classes, ``size`` px."""
    return mod.ServerConfig(model=mod.ModelConfig(name="resnet50", source="native",
                                                  zoo_width=width, input_size=(size, size),
                                                  preprocess="caffe", dtype="int8"),
                            canvas_buckets=(size,), max_batch=4, warmup=False)


def _build_gate(make):
    """An int8 engine built: ("pass", its parity dict) or ("refused", the
    gate's error text)."""
    try:
        eng = make()
    except RuntimeError as e:
        return "refused", str(e)
    eng.close()
    return "pass", eng.parity


def _gates(width, size=64):
    """Each package's int8 engine built, as :func:`_build_gate`."""
    return (_build_gate(lambda: JaxEngine(_gate_cfg(jcfg, width, size),
                                          mesh=build_mesh(jax.devices()[:1]))),
            _build_gate(lambda: InferenceEngine(_gate_cfg(tcfg, width, size), device="cpu")))


@pytest.mark.parametrize("width,verdict", [(0.25, "pass"), (1.0, "refused")])
def test_int8_gate_verdict_equals_the_reference(width, verdict):
    """Same seeded weights, same probe: at width 0.25 both gates pass; at
    full width both raise "numerical-parity gate failed" (their bf16
    roundings differ, so the deltas are close, not equal)."""
    (jv, jp), (tv, tp) = _gates(width)
    assert jv == tv == verdict, (jp, tp)
    if verdict == "refused":
        for text in (jp, tp):
            assert text.startswith("numerical-parity gate failed for resnet50 dtype=int8: ")
            assert "'pass': False" in text
    else:
        assert (tp["tol_prob"], tp["tol_topk"], tp["probe_batch"]) == (
            jp["tol_prob"], jp["tol_topk"], jp["probe_batch"]) == (0.15, 0.90, 4)
        assert tp["topk_agreement"] == jp["topk_agreement"] == 1.0
        assert tp["max_prob_delta"] <= 0.15 and jp["max_prob_delta"] <= 0.15


def _reference_int8_logits(x: np.ndarray) -> np.ndarray:
    """The reference's int8 forward as its serve function traces it
    (``quantize_params``, ``dequantize_tree`` to bf16, the flax model in
    bf16) on the seeded full-width weights: logits in float32."""
    model = jax_get("resnet50").build(num_classes=1000, width=1.0)
    qp = jquant.quantize_params(jax_native("resnet50", seed=0, input_size=x.shape[1]).params,
                                jnp.bfloat16)

    def fn(params, xin):
        params = jquant.dequantize_tree(params, jnp.bfloat16)
        tree = unflatten_dict({tuple(k.split("/")): v for k, v in params.items()})
        return model.apply(tree, xin.astype(jnp.bfloat16), train=False)

    return np.asarray(jax.jit(fn)(qp, x)).astype(np.float32)


def test_int8_gate_at_224_px_turns_on_the_reference_stem_order(monkeypatch):
    """ROADMAP Queue 3, fault 7: at the served 224 px and full width the
    reference's gate refuses the seeded int8 tier. Since the port computes
    its stem as the reference does (space-to-depth), its gate on the card
    refuses it too, with the same max_prob_delta 0.5 (``chip_smoke.py``'s
    ``resnet50`` phase requires it); on the CPU it passes (pinned last
    here). The reference's verdict turns on the summation order of its own
    stem. Its ConvBN runs the 7×7 stride-2 stem through the space-to-depth
    rewrite (``ops/stem.py``, exact in real arithmetic): two classes of one
    probe image round to one bf16 logit, max_prob_delta 0.5, refused. With
    a plain stride-2 conv in its place (the same math, another order) no
    image ties and the same gate passes. The port's int8 logits and the
    reference's in either order lie within one bf16 spacing of each other
    at the top logits' magnitude, so no order of operations copied from
    the reference carries its verdict at this size."""
    jax_gate = lambda: _build_gate(lambda: JaxEngine(  # noqa: E731
        _gate_cfg(jcfg, 1.0, 224), mesh=build_mesh(jax.devices()[:1])))
    x = np.random.RandomState(0).uniform(-1.0, 1.0, (4, 224, 224, 3)).astype(np.float32)
    verdict, text = jax_gate()
    assert verdict == "refused" and "'max_prob_delta': 0.5," in text, text
    logits = {"reference": _reference_int8_logits(x)}
    with monkeypatch.context() as m:
        m.setattr(jstem, "worthwhile", lambda *a, **k: False)
        verdict, parity = jax_gate()
        assert verdict == "pass" and parity["topk_agreement"] == 1.0, parity
        assert parity["max_prob_delta"] <= parity["tol_prob"]
        logits["reference, plain stem"] = _reference_int8_logits(x)
    model = native_converted("resnet50", int8=True).to(torch.bfloat16)
    with torch.no_grad():
        logits["port"] = model.backbone(
            torch.from_numpy(x).to(torch.bfloat16).permute(0, 3, 1, 2)).float().numpy()
    top2 = {k: np.sort(v, 1)[:, -2:] for k, v in logits.items()}
    assert np.any(top2["reference"][:, 0] == top2["reference"][:, 1])
    assert not np.any(top2["reference, plain stem"][:, 0] == top2["reference, plain stem"][:, 1])
    spacing = 2.0 ** (np.floor(np.log2(np.abs(logits["reference"]).max())) - 7)
    names = sorted(logits)
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            assert np.abs(logits[a] - logits[b]).max() <= spacing, (a, b)
    # the port's gate on the CPU, with the reference's stem: no probe image
    # ties here (the top two logits two bf16 spacings apart), so it passes
    verdict, parity = _build_gate(lambda: InferenceEngine(_gate_cfg(tcfg, 1.0, 224),
                                                          device="cpu"))
    assert verdict == "pass" and parity["max_prob_delta"] <= parity["tol_prob"], parity
    assert not np.any(top2["port"][:, 0] == top2["port"][:, 1])


def _images(seed, dims=((96, 96), (72, 48), (48, 64), (17, 23), (95, 33))):
    rs = np.random.RandomState(seed)
    out = []
    for h, w in dims:
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        img = np.stack([yy * 2, xx * 2, 200 - yy - xx], -1) + rs.normal(0, 20, (h, w, 3))
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return out


@pytest.mark.parametrize("wire,resize", [("ragged", "matmul"), ("ragged", "gather"),
                                         ("yuv420", "matmul")])
def test_engine_topk_matches_jax(wire, resize):
    """The same weights in both engines; float32, the same images: top-k
    indices identical, scores within 1e-4. On yuv420 both engines feed
    the stem space-to-depth cells straight from the resize (the
    handshake); on the ragged wire both models fold the image themselves.

    Both engines get the seeded weights with the dense kernel scaled by
    1e-4 (:func:`_unsaturated`: on caffe inputs the seeded softmax is
    one-hot)."""
    ragged = wire == "ragged"
    common = dict(canvas_buckets=(CANVAS,), max_batch=8, wire_format="rgb" if ragged else wire,
                  ragged=ragged, resize=resize, warmup=False)
    params = _unsaturated(jax_native("resnet50", num_classes=CLASSES, width=WIDTH,
                                     seed=0).params, 1e-4)
    jeng = JaxEngine(jcfg.ServerConfig(model=jcfg.ModelConfig(**MODEL), **common),
                     mesh=build_mesh(jax.devices()[:1]))
    # the JAX engine takes no weights: its serve functions read each
    # replica's params, which are replaced here
    for rep in jeng._replicas:
        rep.params = jax.device_put(params, rep.replicated)
    teng = InferenceEngine(tcfg.ServerConfig(model=tcfg.ModelConfig(**MODEL), **common),
                           device="cpu", params_flat=params)
    try:
        assert teng.ragged == jeng.ragged == ragged and teng.parity is None
        images = _images(3)
        hws = np.array([im.shape[:2] for im in images], np.int32)
        if ragged:
            got = teng.run_ragged(images, hws, CANVAS)
            slab = jeng.acquire_ragged(len(images), CANVAS)
            for im in images:
                i, view = slab.alloc(im.size)
                view[:] = im.reshape(-1)
                slab.write_hw(i, im.shape[:2])
            want = jeng.fetch_outputs(jeng.dispatch_ragged(slab, len(images)))
        else:
            prepared = [teng.prepare(im) for im in images]
            for (cj, hj), (ct, ht) in zip(map(jeng.prepare, images), prepared):
                assert hj == ht
                np.testing.assert_array_equal(cj, ct)
            canvases = np.stack([c for c, _ in prepared])
            got = teng.run_batch(canvases, hws)
            want = jeng.run_batch(canvases, hws)
        assert got[0].shape == (5, 3) and got[1].dtype == np.int32
        # no ties at 0.0, and each image its own scores
        assert got[0].min() > 1e-3 and len({tuple(r) for r in got[0]}) == len(images)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_allclose(got[0], want[0], atol=1e-4)
        if ragged:  # the classic rgb wire on the same canvases answers alike
            canvases = np.stack([pad_to_canvas(im, (CANVAS,))[0] for im in images])
            classic = teng.run_batch(canvases, hws)
            np.testing.assert_array_equal(classic[1], got[1])
            np.testing.assert_array_equal(classic[0], got[0])
    finally:
        teng.close()
        jeng.close()


def test_kernel_resize_refuses_caffe_with_the_reference_text():
    def err(mod, resize):
        with pytest.raises(ValueError) as e:
            mod.ServerConfig(model=mod.model_config("native:resnet50"), wire_format="yuv420",
                             resize=resize)
        return str(e.value)

    want = err(jcfg, "pallas")
    assert want == "resize='pallas' supports preprocess inception/zero_one/raw, not 'caffe'"
    assert err(tcfg, "kernel") == want.replace("pallas", "kernel")
    mc = tcfg.model_config("native:resnet50")
    ref = jcfg.model_config("native:resnet50")
    assert (mc.input_size, mc.preprocess) == (ref.input_size, ref.preprocess) == (
        (224, 224), "caffe")


def _conv_macs(cell, out: int) -> int:
    return cell.conv.weight.numel() * out * out


def _logit_rel(a, b):
    """max |a − b| over max |b| (``chip_smoke.logit_rel``)."""
    return float((a.float() - b.float()).abs().max() / b.float().abs().max())


def test_logit_gates_see_what_they_are_meant_to_see(monkeypatch):
    """The card's ResNet-50 check compares logits at full width and 224
    px: bf16 against float32 within 1e-2 (``chip_smoke.BF16_LOGIT_RTOL``)
    and the card's float32 against the CPU's within 1e-4
    (``F32_LOGIT_RTOL``). On the CPU, on caffe-normalized images: bf16
    rounding stays within the first. A wrong max-pool pad (torch's
    ``padding=1``) or a wrong stem pad ((3, 3) where lax pads (2, 3))
    moves float32 logits by between 1e-3 and 1e-2, past the second and
    inside the first: the float32 check is the one that sees a wrong
    forward (the seeded network's logits move little with its input)."""
    rs = np.random.RandomState(0)
    yy, xx = np.mgrid[0:224, 0:224].astype(np.float32)
    imgs = [np.stack([yy * (1 + i), xx * 2, 200 - yy - xx], -1) + rs.normal(0, 20, (224, 224, 3))
            for i in range(3)]
    bgr_mean = np.array([103.939, 116.779, 123.68], np.float32)
    x = torch.from_numpy(np.clip(np.stack(imgs), 0, 255).astype(np.float32) - bgr_mean)
    x = x.permute(0, 3, 1, 2)
    model = native_converted("resnet50").backbone
    with torch.no_grad():
        want = model(x)
        bf16 = copy.deepcopy(model).to(torch.bfloat16, memory_format=torch.channels_last)(
            x.to(torch.bfloat16).contiguous(memory_format=torch.channels_last))
        assert _logit_rel(bf16, want) <= 1e-2
        with monkeypatch.context() as m:
            m.setattr(resnet50_module, "max_pool_same", lambda t: F.max_pool2d(t, 3, 2, 1))
            wrong_pool = _logit_rel(model(x), want)
        model.stem.padding = ((3, 3), (3, 3))  # the stem functions take explicit pads
        wrong_stem = _logit_rel(model(x), want)
    assert 1e-3 < wrong_pool < 1e-2 and 1e-3 < wrong_stem < 1e-2, (wrong_pool, wrong_stem)


def test_cost_walker_counts_the_served_module():
    """The walker's FLOPs at 224 px, full width, are twice the multiply-adds
    of the module's own convs and dense layer, counted from its weights'
    shapes and strides (built on the meta device, never run); its
    parameter count is the module's."""
    size = 224
    with torch.device("meta"):
        model = ResNet50()
    h = math.ceil(size / model.stem.stride)
    macs = _conv_macs(model.stem, h)
    h = math.ceil(h / 2)  # the max pool
    for name in model.block_names:
        block = model.get_submodule(name)
        h_in, h = h, math.ceil(h / block.conv2.stride)
        macs += _conv_macs(block.conv1, h_in) + _conv_macs(block.conv2, h) \
            + _conv_macs(block.conv3, h)
        if block.downsample is not None:
            macs += _conv_macs(block.downsample, h)
    macs += model.logits.weight.numel()
    cost = costmodel.model_cost(tcfg.ModelConfig(name="resnet50", input_size=(size, size)))
    assert h == 7 and macs == cost["macs_per_image"]
    assert cost["flops_per_image"] == 2 * macs
    assert round(cost["flops_per_image"] / 1e9, 2) == 8.18
    assert cost["param_count"] == sum(p.numel() for p in model.parameters())


def _post(url, data):
    req = urllib.request.Request(url, data=data, method="POST",
                                 headers={"Content-Type": "application/json"
                                          if data[:1] == b"{" else "image/jpeg"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_server_serves_resnet50_and_refuses_its_full_width_int8(tmp_path):
    """A small ResNet-50 behind ``POST /predict`` answers like its engine;
    ``POST /models/load`` of its int8 tier at full width (64 px, to stay
    small) ends in FAILED with the gate's message, and the served version
    still answers."""
    (tmp_path / "int8.json").write_text(json.dumps(
        {"name": "resnet50", "source": "native", "input_size": [64, 64],
         "preprocess": "caffe"}))
    cfg = tcfg.ServerConfig(model=tcfg.ModelConfig(**MODEL), host="127.0.0.1", port=0,
                            canvas_buckets=(CANVAS,), max_batch=4)
    buf = io.BytesIO()
    Image.fromarray(_images(5)[0]).save(buf, "JPEG", quality=90)
    with start_server(cfg, device="cpu") as srv:
        status, body = _post(srv.url + "/predict", buf.getvalue())
        assert status == 200 and body["model"] == "resnet50"
        assert len(body["predictions"]) == 3
        status, doc = _post(srv.url + "/models/load", json.dumps(
            {"model": f"{tmp_path / 'int8.json'},dtype=int8,as=resnet50_int8",
             "wait": True}).encode())
        assert status == 500 and doc["state"] == "FAILED", doc
        assert "numerical-parity gate failed for resnet50 dtype=int8" in doc["error"]
        again, body2 = _post(srv.url + "/predict", buf.getvalue())
        assert again == 200 and body2["predictions"] == body["predictions"]
        with urllib.request.urlopen(srv.url + "/models", timeout=30) as r:
            models = json.loads(r.read())["models"]
        assert [v["state"] for v in models["resnet50"]["versions"]] == ["SERVING"]
        assert [v["state"] for v in models["resnet50_int8"]["versions"]] == ["FAILED"]
