"""The port's ``tools/train.py``, ``train/checkpoint.py`` and ``--ckpt``
serving on the CPU (``--device cpu``), mirroring the reference's
``tests/test_train_cli.py`` and ``tests/test_checkpoint.py``: train a tiny
MobileNetV2 (width 0.25, 4 classes, 32 px) on synthetic data, checkpoint,
resume, export, and serve the export through ``InferenceEngine`` and the
HTTP server; carry JAX-trained parameters over; the data sources' batches
against the reference tool's; the server's ``--ckpt`` rules with the
reference's texts.
"""

import io
import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict
from PIL import Image

import server as ref_server
from tensorflow_web_deploy_tpu import models as jax_models
from tensorflow_web_deploy_tpu.models.adapter import init_variables as jax_init
from tensorflow_web_deploy_tpu.train import create_train_state as jax_state
from tensorflow_web_deploy_tpu.train import make_train_step as jax_step
from tensorflow_web_deploy_tpu_torch import server as port_server
from tensorflow_web_deploy_tpu_torch.models import get as torch_get
from tensorflow_web_deploy_tpu_torch.models.adapter import (
    EXPORT_FILE,
    from_jax_params,
    init_variables,
    read_serving_export,
    restore_serving_export,
)
from tensorflow_web_deploy_tpu_torch.serving.engine import InferenceEngine
from tensorflow_web_deploy_tpu_torch.tools import train as port_tool
from tensorflow_web_deploy_tpu_torch.train import adamw, create_train_state, make_train_step
from tensorflow_web_deploy_tpu_torch.train.checkpoint import Checkpointer
from tensorflow_web_deploy_tpu_torch.utils.config import ModelConfig, ServerConfig
from tools import train as ref_tool

torch.set_num_threads(2)

WIDTH, CLASSES, SIZE = 0.25, 4, 32
TOOL = ["--model", "mobilenet_v2", "--width", "0.25", "--classes", "4", "--input-size", "32",
        "--batch", "16", "--lr", "3e-3", "--device", "cpu"]


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("train_run")
    rc = port_tool.main(TOOL + ["--steps", "6", "--ckpt-dir", str(d), "--log-every", "3",
                                "--save-every", "4"])
    assert rc == 0
    return d


def _probs(module, img: np.ndarray) -> np.ndarray:
    x = torch.from_numpy(img[None].astype(np.float32) / 127.5 - 1.0).permute(0, 3, 1, 2)
    with torch.no_grad():
        return torch.softmax(module.eval()(x), -1).numpy()[0]


def _engine(export=None, params_flat=None) -> InferenceEngine:
    mc = ModelConfig(name="mobilenet_v2", source="native", zoo_width=WIDTH, zoo_classes=CLASSES,
                     input_size=(SIZE, SIZE), preprocess="inception", dtype="float32",
                     topk=CLASSES, ckpt_path=export)
    cfg = ServerConfig(model=mc, canvas_buckets=(48,), max_batch=8, warmup=False)
    return InferenceEngine(cfg, device="cpu", params_flat=params_flat)


def _served(engine, img):
    canvases = np.stack([engine.prepare(img)[0]])
    return engine.run_batch(canvases, np.full((1, 2), SIZE, np.int32))


# ------------------------------------------------------------------- the tool


def test_checkpoints_and_export_written(run_dir):
    export = run_dir / "export"
    assert (export / EXPORT_FILE).is_file()
    assert (export / "labels.txt").read_text().split() == [f"class_{i}" for i in range(4)]
    ck = Checkpointer(str(run_dir))
    assert ck.latest_step() == 6 and ck.steps() == [4, 6]
    ck.close()
    flat = read_serving_export(str(export))
    _, seeded = init_variables(torch_get("mobilenet_v2"), num_classes=CLASSES, width=WIDTH)
    assert sorted(flat) == sorted(seeded)  # the JAX package's flat layout, no optimizer state
    assert all(flat[k].shape == seeded[k].shape for k in flat)


def test_resume_continues_from_checkpoint(tmp_path, capsys):
    """A run stopped at step 4 and resumed to 6 prints the reference's line
    and exports what an uninterrupted run to 6 exports, bit for bit
    (batches are a function of (seed, step), the optimizer's moments are
    restored)."""
    common = TOOL + ["--log-every", "2"]
    assert port_tool.main(common + ["--steps", "4", "--save-every", "2", "--no-export",
                                    "--ckpt-dir", str(tmp_path / "a")]) == 0
    capsys.readouterr()
    assert port_tool.main(common + ["--steps", "6", "--ckpt-dir", str(tmp_path / "a")]) == 0
    out = capsys.readouterr().out
    assert "resumed from step 4" in out and "step 6/6 loss=" in out
    assert port_tool.main(common + ["--steps", "6", "--ckpt-dir", str(tmp_path / "b")]) == 0
    resumed = read_serving_export(str(tmp_path / "a" / "export"))
    straight = read_serving_export(str(tmp_path / "b" / "export"))
    for k in straight:
        np.testing.assert_array_equal(resumed[k], straight[k], err_msg=k)


def test_tool_refusals():
    with pytest.raises(SystemExit, match="is a detect model"):
        port_tool.main(["--model", "ssd_mobilenet", "--device", "cpu"])
    with pytest.raises(SystemExit, match="a model axis spans ranks"):
        port_tool.main(TOOL + ["--model-axis", "2"])


def test_data_batches_equal_the_reference_tools(tmp_path):
    for step in (0, 1, 7):
        got = port_tool.SyntheticData(5, 12, 6, 3).batch_at(step)
        want = ref_tool.SyntheticData(5, 12, 6, 3).batch_at(step)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    rs = np.random.RandomState(0)
    for c, n in (("cat", 3), ("dog", 2)):
        (tmp_path / c).mkdir()
        for i in range(n):
            img = (rs.rand(20 + 7 * i, 30 - 3 * i, 3) * 255).astype(np.uint8)
            Image.fromarray(img).save(tmp_path / c / f"{i}.png")
    (tmp_path / "dog" / "notes.txt").write_text("not an image")
    got_src, want_src = (m.FolderData(str(tmp_path), 16, 5, 1) for m in (port_tool, ref_tool))
    assert got_src.classes == want_src.classes == ["cat", "dog"]
    assert len(got_src.items) == len(want_src.items) == 5
    for step in (0, 3):
        for a, b in zip(got_src.batch_at(step), want_src.batch_at(step)):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------- checkpoints


def _tiny_state(seed: int = 0):
    module, params = init_variables(torch_get("mobilenet_v2"), num_classes=CLASSES,
                                    width=WIDTH, seed=seed)
    return module, create_train_state(module, params, adamw(1e-3), device="cpu")


def test_save_restore_resume(tmp_path):
    module, state = _tiny_state()
    step = make_train_step(module)
    rs = np.random.RandomState(0)
    x, y = rs.rand(8, SIZE, SIZE, 3).astype(np.float32), rs.randint(0, CLASSES, 8)
    for _ in range(2):
        state, _ = step(state, x, y)
    ck = Checkpointer(str(tmp_path / "ckpt"))
    ck.save(state["step"], state)
    ck.wait()
    assert ck.latest_step() == 2

    fresh_module, fresh = _tiny_state(seed=1)
    restored = ck.restore(fresh)
    assert restored["step"] == 2
    for key in ("params", "batch_stats"):
        for k, v in state[key].items():
            torch.testing.assert_close(restored[key][k], v, rtol=0, atol=0, msg=k)
    want_opt = state["opt_state"].state_dict()["state"]
    got_opt = restored["opt_state"].state_dict()["state"]
    assert sorted(got_opt) == sorted(want_opt)
    for i in want_opt:
        for name, v in want_opt[i].items():
            torch.testing.assert_close(got_opt[i][name], v, rtol=0, atol=0)
    # the restored state drives its model: one more step on both, equal
    state, m1 = step(state, x, y)
    restored, m2 = make_train_step(fresh_module)(restored, x, y)
    assert restored["step"] == 3 and float(m1["loss"]) == float(m2["loss"])
    ck.close()


def test_restore_empty_dir_returns_none(tmp_path):
    ck = Checkpointer(str(tmp_path / "empty"))
    assert ck.latest_step() is None
    assert ck.restore({"step": np.zeros((), np.int32)}) is None
    ck.close()


def test_max_to_keep_prunes_and_a_torn_step_is_not_picked(tmp_path):
    ck = Checkpointer(str(tmp_path / "keep"), max_to_keep=2)
    for step in (1, 2, 3):
        ck.save(step, {"step": np.asarray(step, np.int32)})
    ck.wait()
    assert ck.latest_step() == 3 and ck.steps() == [2, 3]
    assert sorted(p.name for p in (tmp_path / "keep").iterdir()) == ["2", "3"]
    # a save that died before its rename leaves a temporary directory only
    torn = tmp_path / "keep" / ".tmp-9-crashed"
    torn.mkdir()
    (torn / "state.pt").write_bytes(b"partial")
    assert ck.latest_step() == 3
    assert int(ck.restore({"step": np.zeros((), np.int32)})["step"]) == 3
    ck.close()


def test_create_false_on_a_missing_directory_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="no checkpoint directory"):
        Checkpointer(str(tmp_path / "typo"), create=False)
    assert not (tmp_path / "typo").exists()
    with pytest.raises(FileNotFoundError, match="no serving export found"):
        read_serving_export(str(tmp_path))


# -------------------------------------------------------------------- serving


def test_served_engine_uses_trained_weights(run_dir):
    """The engine with ``ckpt_path`` serves the export: its top-k equals
    the eval-mode model built from the export (rtol 1e-4 / atol 1e-6, the
    reference test's), and the seeded init's probabilities differ."""
    export = str(run_dir / "export")
    engine = _engine(export)
    assert engine.stats()["ckpt"] == export
    img = (np.random.RandomState(1).rand(SIZE, SIZE, 3) * 255).astype(np.uint8)
    scores, idx = _served(engine, img)
    engine.close()

    trained = torch_get("mobilenet_v2").build(num_classes=CLASSES, width=WIDTH)
    trained.load_state_dict(from_jax_params(read_serving_export(export)))
    probs = _probs(trained, img)
    order = np.argsort(-probs)
    np.testing.assert_array_equal(idx[0], order)
    np.testing.assert_allclose(scores[0], probs[order], rtol=1e-4, atol=1e-6)
    seeded, _ = init_variables(torch_get("mobilenet_v2"), num_classes=CLASSES, width=WIDTH)
    assert np.abs(probs - _probs(seeded, img)).max() > 1e-4
    # an export of another width is refused with its key, not at load
    _, wider = init_variables(torch_get("mobilenet_v2"), num_classes=CLASSES, width=0.5)
    with pytest.raises(ValueError, match="has shape"):
        restore_serving_export(wider, export)


def test_jax_trained_parameters_carry_over(rng):
    """Three reference train steps (optax adam 3e-3, float32), the state
    flattened to numpy and passed through ``from_jax_params``: the port's
    engine gives the reference's ``model.apply(train=False)``
    probabilities (top-k equal, rtol 1e-4 / atol 1e-6)."""
    model, variables = jax_init(jax_models.get("mobilenet_v2"), num_classes=CLASSES,
                                width=WIDTH, seed=3)
    tx = optax.adam(3e-3)
    state = jax_state(model, variables, tx)
    step = jax_step(model, tx)
    x = jnp.asarray(rng.rand(8, SIZE, SIZE, 3), jnp.float32)
    y = jnp.asarray(rng.randint(0, CLASSES, 8), jnp.int32)
    for _ in range(3):
        state, _ = step(state, x, y)
    trained = {"params": state["params"], "batch_stats": state["batch_stats"]}
    flat = {"/".join(k): np.asarray(v) for k, v in flatten_dict(trained).items()}
    img = (rng.rand(SIZE, SIZE, 3) * 255).astype(np.uint8)
    logits = jax.jit(lambda v, a: model.apply(v, a, train=False))(
        trained, img[None].astype(np.float32) / 127.5 - 1.0)
    probs = np.asarray(jax.nn.softmax(logits, -1))[0]
    engine = _engine(params_flat=flat)
    scores, idx = _served(engine, img)
    engine.close()
    order = np.argsort(-probs)
    np.testing.assert_array_equal(idx[0], order)
    np.testing.assert_allclose(scores[0], probs[order], rtol=1e-4, atol=1e-6)


# --------------------------------------------------------------------- the CLI


@pytest.mark.parametrize("argv", [
    ["--model", "inception_v3", "--ckpt", "runs/x/export"],
    ["--model", "native:inception_v3", "--model", "native:mobilenet_v2", "--ckpt", "e"],
])
def test_ckpt_refusals_carry_the_reference_texts(argv):
    with pytest.raises(SystemExit) as ref:
        ref_server.build_server(ref_server.parse_args(argv))
    with pytest.raises(ValueError) as got:
        port_server.config_from_args(port_server.parse_args(argv))
    assert str(got.value) == ref.value.code
    with pytest.raises(SystemExit) as main_exit:
        port_server.main(argv)
    assert main_exit.value.code == ref.value.code


def test_ckpt_server_answers_with_the_exports_labels(run_dir, tmp_path):
    export = str(run_dir / "export")
    base = ["--model", "native:mobilenet_v2", "--ckpt", export]
    cfg = port_server.config_from_args(port_server.parse_args(base))
    assert (cfg.model.ckpt_path, cfg.model.labels_path) == (export, f"{export}/labels.txt")
    mine = tmp_path / "mine.txt"
    cfg = port_server.config_from_args(port_server.parse_args(base + ["--labels", str(mine)]))
    assert cfg.model.labels_path == str(mine)
    cfg = port_server.config_from_args(port_server.parse_args(base + [
        "--zoo-width", "0.25", "--zoo-classes", "4", "--dtype", "f32", "--canvas-buckets", "64",
        "--max-batch", "2", "--host", "127.0.0.1", "--port", "0", "--no-warmup"]))
    buf = io.BytesIO()
    Image.fromarray((np.random.RandomState(2).rand(40, 50, 3) * 255).astype(np.uint8)).save(
        buf, "JPEG")
    with port_server.start_server(cfg, device="cpu") as srv:
        req = urllib.request.Request(srv.url + "/predict", data=buf.getvalue(), method="POST",
                                     headers={"Content-Type": "image/jpeg"})
        with urllib.request.urlopen(req, timeout=60) as r:
            assert r.status == 200
            preds = json.loads(r.read())["predictions"]
        with urllib.request.urlopen(srv.url + "/stats", timeout=60) as r:
            assert json.loads(r.read())["engine"]["ckpt"] == export
    assert {p["label"] for p in preds} <= {f"class_{i}" for i in range(4)} and preds
