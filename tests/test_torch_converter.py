"""The port's frozen-graph path against the JAX package's, on the CPU.

- A whole graph (``small_cls_pb``, a Keras-frozen MobileNetV2) through
  both converters: float32 within 1e-5, bf16 within 1e-2 of the
  reference's bf16; the const-only subgraphs (the BN chains on the moving
  statistics) fold at build and run no kernel per call.
- The detector graph (``small_ssd_pb``): the same three outputs.
- Weights carried across from the reference's ``ConvertedModel.params``:
  the port's buffers are those arrays, in the port's layouts, after the
  compute-dtype cast.
- ``/predict`` through the JAX App and the port's on the same ``.pb``,
  classify and detect.
- The int8 tier: the quantized key set and the gate's verdict, on the
  Keras graph (nothing quantized: its kernels are ``…/resource``) and on a
  graph whose kernels are named ``weights``.
- ``model_config``: presets, ``.pb``, ``.json`` with ``pb_path`` and no
  ``source``, the per-model ``pipeline_depth``/``max_queue`` reaching the
  batcher, the reference's error texts; the cost model by name.
- The port's TF-free tool: its bytes parse with TF and with the
  reference's parser, the reference's converter on them equals the port's
  native zoo forward on the same params, and its op types are those of
  Keras's frozen graph of the same family.
"""

from __future__ import annotations

import io
import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tensorflow_web_deploy_tpu.graphdef import convert_graphdef as ref_convert
from tensorflow_web_deploy_tpu.graphdef import parse_graphdef as ref_parse
from tensorflow_web_deploy_tpu.ops import quant as jquant
from tensorflow_web_deploy_tpu.parallel.mesh import build_mesh
from tensorflow_web_deploy_tpu.serving import http as jhttp
from tensorflow_web_deploy_tpu.serving.engine import InferenceEngine as JaxEngine
from tensorflow_web_deploy_tpu.serving.registry import ModelRegistry as JaxRegistry
from tensorflow_web_deploy_tpu.utils import config as jcfg
from tensorflow_web_deploy_tpu_torch.graphdef import (
    convert_graphdef,
    convert_pb,
    load_pb,
    parse_graphdef,
)
from tensorflow_web_deploy_tpu_torch.graphdef.converter import to_port_layout
from tensorflow_web_deploy_tpu_torch.models.adapter import native_converted
from tensorflow_web_deploy_tpu_torch.ops import quant
from tensorflow_web_deploy_tpu_torch.server import config_from_args, parse_args
from tensorflow_web_deploy_tpu_torch.serving import costmodel
from tensorflow_web_deploy_tpu_torch.serving.engine import InferenceEngine
from tensorflow_web_deploy_tpu_torch.serving.http import App, make_http_server, shutdown_gracefully
from tensorflow_web_deploy_tpu_torch.serving.registry import ModelRegistry
from tensorflow_web_deploy_tpu_torch.tools import make_artifacts
from tensorflow_web_deploy_tpu_torch.utils import config as tcfg
from tests.test_torch_registry import MockEngine
from tests.tf_golden import build_graph

F32_TOL = 1e-5
# The "lively" graph (He-normal kernels) amplifies float32 summation-order
# differences through 52 convs: the port's logits lie 0.9–1.3e-5 of their
# scale from the reference's (XLA's convs, its s2d stem), its
# probabilities 2.6–6.4e-6 (measured); held to 1e-4 and 2e-5.
LIVELY_F32_RTOL = 1e-4
LIVELY_F32_PROB_TOL = 2e-5
# bf16 on the Keras graph as frozen: probabilities within 1e-2 of the
# reference's bf16. On the lively graph bf16 is chaotic in both packages
# (the reference's own bf16 logits lie 18–21% of their scale from its
# float32): the port's bf16 may deviate from float32 at most 1.5× as much
# as the reference's does (measured 0.80–1.24×)
BF16_TOL = 1e-2
BF16_DEVIATION_RATIO = 1.5
# /predict on the lively graph, float32: the preprocess (resize) in
# another order too, amplified as above (2.1e-5 measured)
PREDICT_SCORE_TOL = 1e-4
# the port's tool against its own zoo forward (another order of the same
# float32 math: BN unfolded, the counted average pool as a Mul)
TOOL_TOL = 1e-4
SIZE = 96


def _images(n: int, size: int = SIZE, seed: int = 0) -> np.ndarray:
    return np.random.RandomState(seed).uniform(-1, 1, (n, size, size, 3)).astype(np.float32)


def _ref_run(model, x: np.ndarray, dtype=None) -> list[np.ndarray]:
    """The reference's converted graph under jax.jit, float32 or ``dtype``
    (params and the float_dtype policy as its engine casts them)."""
    if dtype is None:
        outs = jax.jit(model.fn)(model.params, x)
    else:
        params = {k: v.astype(dtype) if v.dtype == np.float32 else v
                  for k, v in model.params.items()}
        outs = jax.jit(lambda p, x: model.fn(p, x.astype(dtype), float_dtype=dtype))(params, x)
    return [np.asarray(o.astype(jnp.float32) if o.dtype == jnp.bfloat16 else o) for o in outs]


def _port_run(model, x: np.ndarray) -> list[np.ndarray]:
    with torch.inference_mode():
        outs = model(torch.from_numpy(x).to(model.dtype))
    return [o.float().numpy() if o.is_floating_point() else o.numpy() for o in outs]


def _logits_ref(graph) -> str:
    return next(n.name for n in graph.nodes if n.op == "BiasAdd")


@pytest.fixture(scope="module")
def lively_cls_pb(small_cls_pb, tmp_path_factory):
    """``small_cls_pb`` with He-normal kernels and spread BN statistics in
    its constants (the same graph, op for op): Keras's seeded init decays
    the activations to ~1e-10 by the logits, where every check passes."""
    import tensorflow as tf

    gd = tf.compat.v1.GraphDef()
    gd.ParseFromString(open(small_cls_pb, "rb").read())
    rs = np.random.RandomState(11)
    for node in gd.node:
        if node.op != "Const" or node.attr["value"].tensor.dtype != tf.float32.as_datatype_enum:
            continue
        v = tf.make_ndarray(node.attr["value"].tensor)
        if v.ndim in (2, 4):
            depthwise = v.ndim == 4 and "depthwise" in node.name
            fan_in = np.prod(v.shape[:2]) if depthwise else np.prod(v.shape[:-1])
            new = rs.randn(*v.shape) * np.sqrt(2.0 / fan_in)
        elif v.ndim == 1 and ("/Cast_1/" in node.name or "/Cast_2/" in node.name):
            new = rs.uniform(0.5, 1.5, v.shape)  # moving variance, gamma
        elif v.ndim == 1:
            new = rs.normal(0, 0.1, v.shape)  # moving mean, beta, the dense bias
        else:
            continue
        node.attr["value"].tensor.CopyFrom(tf.make_tensor_proto(new.astype(np.float32)))
    path = tmp_path_factory.mktemp("lively") / "lively_cls.pb"
    path.write_bytes(gd.SerializeToString())
    return str(path)


@pytest.fixture(scope="module")
def cls_graph(lively_cls_pb):
    data = open(lively_cls_pb, "rb").read()
    return data, parse_graphdef(data), ref_parse(data)


def _graphs(path: str):
    data = open(path, "rb").read()
    graph = parse_graphdef(data)
    return graph, ref_parse(data), ["Identity", _logits_ref(graph)]


def test_whole_graph_float32_equals_the_reference(small_cls_pb, lively_cls_pb):
    """The Keras graph as frozen (its activations decay to ~1e-10 by the
    logits) within 1e-5; the lively graph within ``LIVELY_F32_RTOL`` of
    its logits' scale and ``LIVELY_F32_PROB_TOL``."""
    x = _images(3)
    graph, rgraph, outputs = _graphs(small_cls_pb)
    want = _ref_run(ref_convert(rgraph, outputs=outputs), x)
    got = _port_run(convert_graphdef(graph, outputs=outputs), x)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=F32_TOL, atol=F32_TOL)
    graph, rgraph, outputs = _graphs(lively_cls_pb)
    want = _ref_run(ref_convert(rgraph, outputs=outputs), x)
    got = _port_run(convert_graphdef(graph, outputs=outputs), x)
    scale = np.abs(want[1]).max()
    assert scale > 1.0  # the lively logits are not near zero
    assert np.abs(got[1] - want[1]).max() <= LIVELY_F32_RTOL * scale
    np.testing.assert_allclose(got[0], want[0], atol=LIVELY_F32_PROB_TOL, rtol=0)
    assert (got[1].argmax(1) == want[1].argmax(1)).all()


def test_whole_graph_bf16_within_tolerance_of_the_reference(small_cls_pb, lively_cls_pb):
    """bf16: every float buffer bf16 (no promotion back to float32); the
    Keras graph's probabilities within ``BF16_TOL`` of the reference's
    bf16; on the lively graph the port's bf16 logits deviate from float32
    at most ``BF16_DEVIATION_RATIO`` × as much as the reference's bf16."""
    x = _images(6, seed=1)
    graph, rgraph, outputs = _graphs(small_cls_pb)
    want = _ref_run(ref_convert(rgraph, outputs=outputs), x, jnp.bfloat16)
    model = convert_graphdef(graph, outputs=outputs, dtype=torch.bfloat16)
    np.testing.assert_allclose(_port_run(model, x)[0], want[0], atol=BF16_TOL, rtol=0)
    assert all(b.dtype == torch.bfloat16 for _, b in model.named_buffers()
               if b.is_floating_point())
    graph, rgraph, outputs = _graphs(lively_cls_pb)
    ref = ref_convert(rgraph, outputs=outputs)
    f32 = _ref_run(ref, x)[1]
    ref16 = _ref_run(ref, x, jnp.bfloat16)[1]
    port16 = _port_run(convert_graphdef(graph, outputs=outputs, dtype=torch.bfloat16), x)[1]
    ref_dev = np.abs(ref16 - f32).max()
    assert 0 < np.abs(port16 - f32).max() <= BF16_DEVIATION_RATIO * ref_dev


def test_const_only_subgraphs_fold_at_build(cls_graph):
    """The Keras BN chains (AddV2, Rsqrt, Mul, Sub on the moving
    statistics) and the ReadVariableOp identities run once, at build: no
    node of them is in the per-call list, and a forward dispatches no
    rsqrt or sub. Per call, each conv keeps its data-side Mul and AddV2."""
    from torch.utils._python_dispatch import TorchDispatchMode

    _, graph, _ = cls_graph
    model = convert_graphdef(graph)
    ops = {n.name: n.op for n in graph.nodes}
    call = dict(model.call_nodes)
    assert not set(call) & set(model.folded_nodes)
    assert {ops[n] for n in model.folded_nodes} >= {"Identity", "AddV2", "Rsqrt", "Mul", "Sub"}
    assert {"Rsqrt", "Sub", "Reshape"}.isdisjoint(call.values())
    convs = sum(op in ("Conv2D", "DepthwiseConv2dNative") for op in call.values())
    assert convs == 52
    assert sum(op == "Mul" for op in call.values()) == convs  # x · (gamma·rsqrt(var + eps))
    # every per-call node depends on the input
    data = {model.input_names[0]}
    for name, _ in model.call_nodes:
        node = graph.node_map[name]
        assert any(r.split(":")[0] in data for r in node.inputs if not r.startswith("^")), name
        data.add(name)

    class Recorder(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.add(func.overloadpacket.__name__)
            return func(*args, **(kwargs or {}))

    with torch.inference_mode(), Recorder() as rec:
        model(torch.from_numpy(_images(1)))
    assert not rec.ops & {"rsqrt", "sub"}, rec.ops
    assert {"mul", "add"} <= rec.ops and rec.ops & {"conv2d", "convolution"}


def test_detector_graph_gives_the_reference_outputs(small_ssd_pb):
    data = open(small_ssd_pb, "rb").read()
    outputs = ["raw_boxes", "raw_scores", "anchors"]
    x = _images(2, seed=2)
    want = _ref_run(ref_convert(ref_parse(data), outputs=outputs), x)
    model = convert_pb(small_ssd_pb, outputs=outputs)
    got = _port_run(model, x)
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=F32_TOL, atol=F32_TOL)
    assert ("anchors", "Identity") not in model.call_nodes  # a constant output: a buffer


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_weights_carry_across_from_the_reference_params(cls_graph, dtype):
    """The port's ConvertedModel built from the reference's params (numpy,
    by node name): every buffer that holds a parameter is that array in
    the port's layout (a conv kernel OIHW, a depthwise kernel [C·M, 1, H,
    W]) after the cast; perturbed params give the reference's outputs on
    the same perturbed params."""
    _, graph, rgraph = cls_graph
    ref = ref_convert(rgraph)
    rs = np.random.RandomState(5)
    params = {k: (v + rs.normal(0, 0.01, v.shape)).astype(np.float32)
              for k, v in ref.params.items()}
    model = convert_graphdef(graph, dtype=dtype, params=params)
    assert set(model.params) == set(ref.params)
    carried = 0
    for key, (origin, layout) in model.buffer_origin.items():
        if origin not in params:
            continue
        want = to_port_layout(layout, torch.from_numpy(params[origin]).to(dtype))
        assert torch.equal(getattr(model, key), want), key
        carried += 1
    assert carried >= 52  # every conv kernel, at least
    assert {layout for _, layout in model.buffer_origin.values()} >= {"oihw", "grouped"}
    if dtype == torch.float32:
        ref.params.update(params)
        x = _images(2, seed=3)
        np.testing.assert_allclose(_port_run(model, x)[0], _ref_run(ref, x)[0],
                                   rtol=F32_TOL, atol=F32_TOL)


# ------------------------------------------------------------------- /predict


def _jpeg(seed: int, h: int, w: int) -> bytes:
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([yy * 1.5, xx * 1.5, 200 - yy - xx], -1) + rs.normal(0, 25, (h, w, 3))
    buf = io.BytesIO()
    Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(buf, "JPEG", quality=92)
    return buf.getvalue()


def _post(port: int, data: bytes):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/predict", data=data, method="POST",
                                 headers={"Content-Type": "image/jpeg"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _both_apps(model: dict):
    """The JAX App and the port's over one-model registries serving the
    same .pb (float32, the ragged rgb wire, canvas 128)."""
    common = dict(canvas_buckets=(128,), max_batch=4, wire_format="rgb", ragged=True,
                  warmup=False)
    jmc = jcfg.ModelConfig(**model)
    jserver = jcfg.ServerConfig(model=jmc, **common)
    jreg = JaxRegistry(jserver, default_model=jmc.serve_name)
    jeng = JaxEngine(jserver, mesh=build_mesh(jax.devices()[:1]))
    jreg.adopt(jmc.serve_name, jeng, jreg.build_batcher(jeng, jmc.serve_name), jmc)
    tmc = tcfg.ModelConfig(**model)
    tserver = tcfg.ServerConfig(model=tmc, **common)
    treg = ModelRegistry(tserver, default_model=tmc.serve_name)
    teng = InferenceEngine(tserver, device="cpu")
    treg.adopt(tmc.serve_name, teng, treg.build_batcher(teng), tmc)
    servers = (jhttp.make_http_server(jhttp.App.from_registry(jreg, jserver), "127.0.0.1", 0,
                                      pool_size=2),
               make_http_server(App(treg, tserver), "127.0.0.1", 0, pool_size=2))
    for srv in servers:
        threading.Thread(target=srv.serve_forever, daemon=True).start()

    def close():
        jhttp.shutdown_gracefully(servers[0], jreg, grace_s=3.0)
        shutdown_gracefully(servers[1], treg, grace_s=3.0)
        jeng.close()
        teng.close()

    return tuple(srv.server_address[1] for srv in servers), teng, close


def test_predict_classifies_as_the_jax_app(lively_cls_pb):
    ports, teng, close = _both_apps(dict(name="small_cls", pb_path=lively_cls_pb,
                                         input_size=(SIZE, SIZE), dtype="float32", topk=5))
    try:
        assert (teng.source, teng.num_classes, teng.kernels) == ("pb", 1000, ["unpack_ragged"])
        for seed, (h, w) in enumerate([(200, 120), (77, 51), (128, 128)]):
            (js, jbody), (ts, tbody) = (_post(p, _jpeg(seed, h, w)) for p in ports)
            assert js == ts == 200, (jbody, tbody)
            assert set(tbody) == set(jbody)
            jp, tp = jbody["predictions"], tbody["predictions"]
            js_ = [p["score"] for p in jp]
            # ranks whose reference scores are apart from both neighbours
            defined = [0] + [j for j in range(1, len(jp) - 1)
                             if js_[j - 1] - js_[j] > PREDICT_SCORE_TOL
                             and js_[j] - js_[j + 1] > PREDICT_SCORE_TOL]
            assert [tp[j]["index"] for j in defined] == [jp[j]["index"] for j in defined]
            np.testing.assert_allclose([p["score"] for p in tp], js_, atol=PREDICT_SCORE_TOL)
        st = teng.stats()
        assert st["source"] == "pb" and st["load_s"]["parse"] > 0
    finally:
        close()


def test_predict_detects_as_the_jax_app(small_ssd_pb):
    ports, teng, close = _both_apps(dict(
        name="small_ssd", pb_path=small_ssd_pb, task="detect", input_size=(SIZE, SIZE),
        dtype="float32", output_names=["raw_boxes", "raw_scores", "anchors"]))
    try:
        assert (teng.num_classes, teng.kernels) == (10, ["unpack_ragged", "nms_fixed"])
        for seed, (h, w) in enumerate([(200, 120), (90, 96)]):
            (js, jbody), (ts, tbody) = (_post(p, _jpeg(seed + 7, h, w)) for p in ports)
            assert js == ts == 200, (jbody, tbody)
            assert set(tbody) == set(jbody) >= {"detections", "num_detections"}
            assert tbody["num_detections"] == jbody["num_detections"] > 0
            for t, j in zip(tbody["detections"], jbody["detections"]):
                assert (t["class"], t["label"]) == (j["class"], j["label"])
                assert abs(t["score"] - j["score"]) <= 1e-5
                np.testing.assert_allclose(t["box"], j["box"], atol=1e-3 * max(h, w))
    finally:
        close()


# ---------------------------------------------------------------------- int8


def _weights_graph() -> bytes:
    """A TF1/slim-style classifier whose kernels are consts named
    ``…/weights``: the reference's int8 tier quantizes those."""
    rs = np.random.RandomState(9)

    def build(tf):
        x = tf.compat.v1.placeholder(tf.float32, [None, 32, 32, 3], name="input")
        w1 = tf.constant((rs.randn(3, 3, 3, 16) * 0.3).astype(np.float32), name="conv1/weights")
        y = tf.nn.relu(tf.nn.conv2d(x, w1, [1, 2, 2, 1], "SAME"))
        w2 = tf.constant((rs.randn(3, 3, 16, 1) * 0.3).astype(np.float32),
                         name="dw/depthwise_weights")
        y = tf.nn.relu6(tf.nn.depthwise_conv2d(y, w2, [1, 1, 1, 1], "SAME"))
        y = tf.reduce_mean(y, axis=[1, 2])
        wf = tf.constant((rs.randn(16, 10) * 0.3).astype(np.float32), name="fc/weights")
        b = tf.constant(np.zeros(10, np.float32), name="fc/biases")
        tf.nn.softmax(tf.matmul(y, wf) + b, name="probs")

    return build_graph(build)


@pytest.mark.parametrize("which", ["keras", "weights"])
def test_int8_quantizes_the_reference_keys_with_its_verdict(which, cls_graph, tmp_path):
    if which == "keras":
        data = cls_graph[0]
        size = SIZE
    else:
        data = _weights_graph()
        size = 32
    path = tmp_path / f"{which}.pb"
    path.write_bytes(data)
    ref = ref_convert(ref_parse(data))
    want_keys = {k for k in jquant.quantize_params(ref.params, jnp.bfloat16)
                 if k.endswith(jquant.QSCALE_SUFFIX)}
    model = convert_graphdef(parse_graphdef(data), dtype=torch.bfloat16, int8=True)
    assert {k + quant.QSCALE_SUFFIX for k in model.int8_params} == want_keys
    if which == "keras":
        assert not want_keys  # Keras-frozen consts end in .../resource
    else:
        assert len(want_keys) == 3
        qref = jquant.quantize_params(ref.params, jnp.bfloat16)
        for k in model.int8_params:
            assert np.array_equal(model.params[k], qref[k])
    model_cfg = dict(name=which, pb_path=str(path), input_size=(size, size), dtype="int8")
    common = dict(canvas_buckets=(64,), max_batch=2, warmup=False)
    jeng = JaxEngine(jcfg.ServerConfig(model=jcfg.ModelConfig(**model_cfg), **common),
                     mesh=build_mesh(jax.devices()[:1]))
    teng = InferenceEngine(tcfg.ServerConfig(model=tcfg.ModelConfig(**model_cfg), **common),
                           device="cpu")
    try:
        assert teng.parity["pass"] == jeng.parity["pass"] is True
        assert abs(teng.parity["max_prob_delta"] - jeng.parity["max_prob_delta"]) <= 1e-2
        assert teng.fused_dw is False
    finally:
        teng.close()
        jeng.close()


# -------------------------------------------------------------- model_config


def test_presets_resolve_as_the_reference():
    assert sorted(tcfg.PRESETS) == sorted(jcfg.PRESETS)
    for name in tcfg.PRESETS:
        got, want = tcfg.model_config(name), jcfg.model_config(name)
        assert got.source == want.source == "pb"
        assert (got.name, got.task, got.input_size, got.preprocess, got.output_names) == \
            (want.name, want.task, want.input_size, want.preprocess, want.output_names)
        assert got.pb_path.endswith(f"artifacts/{name}.pb")
        assert got.labels_path.rsplit("/", 1)[1] == want.labels_path.rsplit("/", 1)[1]
        assert got.fuse_depthwise is False
    got = tcfg.model_config("mobilenet_v2,dtype=int8,as=mobilenet_v2_int8")
    assert (got.source, got.dtype, got.serve_name) == ("pb", "int8", "mobilenet_v2_int8")
    assert tcfg.model_config("native:inception_v3").source == "native"


def test_pb_paths_and_json_configs_resolve(tmp_path):
    got = tcfg.model_config(str(tmp_path / "frozen_net.pb"))
    want = jcfg.model_config(str(tmp_path / "frozen_net.pb"))
    assert (got.name, got.source, got.pb_path) == (want.name, want.source, want.pb_path)
    cfg = tmp_path / "net.json"
    cfg.write_text(json.dumps({"name": "net", "pb_path": "x.pb", "input_size": [96, 96],
                               "pipeline_depth": 1, "max_queue": 7}))
    got = tcfg.model_config(str(cfg))
    assert (got.source, got.pb_path, got.input_size) == ("pb", "x.pb", (96, 96))
    assert (got.pipeline_depth, got.max_queue) == (1, 7)
    cfg.write_text(json.dumps({"name": "mobilenet_v2", "zoo_width": 0.25}))
    assert tcfg.model_config(str(cfg)).source == "native"
    args = parse_args(["--model", str(tmp_path / "frozen_net.pb"), "--model",
                       "inception_v3,as=preset", "--device", "cpu"])
    sc = config_from_args(args)
    assert [(m.serve_name, m.source) for m in sc.serve_models] == [("frozen_net", "pb"),
                                                                   ("preset", "pb")]


def test_refusals_carry_the_reference_texts():
    for mod in (tcfg, jcfg):
        with pytest.raises(ValueError) as e:
            mod.ModelConfig(name="m", source="pb")
        with pytest.raises(ValueError) as u:
            mod.model_config("nothing_like_a_model")
        if mod is tcfg:
            texts = (str(e.value), str(u.value))
    assert texts == (str(e.value), str(u.value))
    assert "source='pb' requires pb_path" in texts[0]
    with pytest.raises(ValueError, match="source must be 'native' or 'pb'"):
        tcfg.ModelConfig(name="m", source="onnx")


def test_per_model_pipeline_knobs_reach_the_batcher():
    server = tcfg.ServerConfig(model=tcfg.ModelConfig(name="a"), pipeline_depth=4, max_queue=0,
                               warmup=False)
    reg = ModelRegistry(server, default_model="a")
    own = MockEngine(tcfg.ServerConfig(model=tcfg.ModelConfig(name="a", pipeline_depth=1,
                                                              max_queue=5)))
    inherit = MockEngine(server)
    batchers = [reg.build_batcher(e) for e in (own, inherit)]
    try:
        assert [(b.pipeline_depth, b.max_queue) for b in batchers] == [(1, 5), (4, 0)]
    finally:
        for b in batchers:
            b.stop()


def test_cost_model_keys_by_name():
    """A preset named for a zoo architecture gets its walker; any other
    graph gets None and economics without FLOP gauges, as the reference."""
    preset = tcfg.model_config("inception_v3")
    native = tcfg.model_config("native:inception_v3")
    assert costmodel.model_cost(preset) == costmodel.model_cost(native) is not None
    assert costmodel.model_cost(tcfg.ModelConfig(name="frozen_net", pb_path="x.pb")) is None


def test_fused_dw_on_is_ignored_for_a_graph_with_the_reference_warning(small_cls_pb, caplog):
    mc = tcfg.ModelConfig(name="small_cls", pb_path=small_cls_pb, input_size=(SIZE, SIZE),
                          dtype="float32", fused_dw="on")
    assert mc.fuse_depthwise is False
    eng = InferenceEngine(tcfg.ServerConfig(model=mc, canvas_buckets=(64,), max_batch=1,
                                            warmup=False), device="cpu")
    try:
        assert eng.fused_dw is False and "fused_dw" not in eng.kernels
        assert "fused_dw='on' ignored for source='pb'" in caplog.text
    finally:
        eng.close()


# ------------------------------------------------------------ the port's tool


def _perturbed(flat: dict, seed: int) -> dict:
    rs = np.random.RandomState(seed)
    out = dict(flat)
    for k, v in flat.items():
        if k.endswith(("/mean", "/bias")):
            out[k] = rs.normal(0, 0.1, v.shape).astype(np.float32)
        elif k.endswith(("/var", "/scale")):
            out[k] = rs.uniform(0.5, 1.5, v.shape).astype(np.float32)
    return out


TOOL_CASES = [("inception_v3", 75, 0.25), ("mobilenet_v2", 96, 0.35), ("mobilenet_v2", 65, 0.35)]


@pytest.mark.parametrize("name,size,width", TOOL_CASES)
def test_tool_graph_equals_the_zoo_forward(name, size, width):
    """The tool's bytes parse with TF's GraphDef and with the reference's
    parser; the reference's converter on them equals the port's native zoo
    forward on the same params (perturbed BN), float32 within 1e-4; the
    port's converter agrees."""
    import tensorflow as tf

    _, flat = make_artifacts.make_graph(name, size=size, width=width, num_classes=10)
    flat = _perturbed(flat, 3)
    data, got_flat = make_artifacts.make_graph(name, size=size, width=width, num_classes=10,
                                               params=flat)
    assert all(np.array_equal(got_flat[k], flat[k]) for k in flat)
    gd = tf.compat.v1.GraphDef()
    gd.ParseFromString(data)
    rgraph = ref_parse(data)
    assert [n.name for n in gd.node] == [n.name for n in rgraph.nodes]
    assert [n.op for n in gd.node] == [n.op for n in rgraph.nodes]
    x = _images(2, size=size, seed=4)
    want = _ref_run(ref_convert(rgraph), x)[0]
    with torch.inference_mode():
        native = native_converted(name, num_classes=10, width=width, params_flat=flat)
        zoo = native(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(want, zoo, rtol=TOOL_TOL, atol=TOOL_TOL)
    np.testing.assert_allclose(_port_run(convert_graphdef(parse_graphdef(data)), x)[0], zoo,
                               rtol=TOOL_TOL, atol=TOOL_TOL)
    assert zoo.max() > 0.2  # not a flat softmax


@pytest.fixture(scope="module")
def keras_inception_ops():
    """The op types of Keras's frozen InceptionV3 (75 px, weights=None)."""
    import tensorflow as tf
    from tensorflow.python.framework.convert_to_constants import (
        convert_variables_to_constants_v2,
    )

    m = tf.keras.applications.InceptionV3(input_shape=(75, 75, 3), weights=None)
    cf = tf.function(lambda x: m(x)).get_concrete_function(
        tf.TensorSpec([None, 75, 75, 3], tf.float32))
    gd = convert_variables_to_constants_v2(cf).graph.as_graph_def()
    return {n.op for n in gd.node}


def test_tool_op_types_equal_kerass_frozen_graphs(small_cls_pb, keras_inception_ops):
    keras_mobilenet = {n.op for n in load_pb(small_cls_pb).nodes}
    for name, size, keras_ops in (("mobilenet_v2", SIZE, keras_mobilenet),
                                  ("inception_v3", 75, keras_inception_ops)):
        data, _ = make_artifacts.make_graph(name, size=size, width=0.25, num_classes=10)
        graph = parse_graphdef(data)
        assert {n.op for n in graph.nodes} == keras_ops, name
        assert graph.nodes[0].attr("shape") == [-1, size, size, 3]  # a dynamic batch
        assert graph.nodes[-1].name == "Identity"
        # the int8 tier finds no kernel leaf here either
        assert not [k for k in convert_graphdef(graph).params if quant.quantizable(k, 0)]


def test_ensure_artifacts_writes_what_is_missing(tmp_path):
    out = make_artifacts.ensure_artifacts(["mobilenet_v2"], tmp_path / "artifacts", width=0.25,
                                          size=64)
    pb = out / "mobilenet_v2.pb"
    assert pb.exists() and (out / "imagenet_labels.txt").exists()
    assert len((out / "imagenet_labels.txt").read_text().splitlines()) == 1000
    before = pb.stat().st_mtime_ns
    make_artifacts.ensure_artifacts(["mobilenet_v2"], out, width=0.25, size=64)
    assert pb.stat().st_mtime_ns == before  # present: not written again
    with pytest.raises(ValueError, match="no frozen-graph emitter for 'resnet50'"):
        make_artifacts.make_graph("resnet50")
    # the command line
    out2 = tmp_path / "cli"
    assert make_artifacts.main(["--models", "inception_v3", "--out", str(out2), "--width",
                                "0.25", "--size", "75"]) == 0
    graph = load_pb(str(out2 / "inception_v3.pb"))
    assert graph.nodes[0].attr("shape") == [-1, 75, 75, 3]
