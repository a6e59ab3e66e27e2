"""The port's sharded train step on four gloo ranks (data 2 × model 2),
held against the JAX package's single-device step and its sharded step
on a 2 × 2 CPU mesh (``tests/test_train.py``'s setup: MobileNetV2 width
0.25, 4 classes, 32 px, batch 8, float64, SGD): the loss within rtol 1e-9
and the eval-mode logits on held-out data within rtol 1e-4 / atol 1e-6.
In the same run: BN's running statistics alike on every rank and equal
to the single device's, every gradient (a sharded depthwise kernel's
among them) the single device's with no factor of the model axis, three
float32 AdamW steps leaving identical states on the ranks that hold the
same shard, and checkpoints across mesh shapes (saved at 2 × 2 and
restored at 1 × 1, 4 × 1 and 1 × 4; saved at 1 × 1 and restored at
2 × 2). Last, ``tools/train.py`` on two gloo ranks with ``--model-axis
2``: it resumes at 2 × 1, and its export serves in the port's engine.

The four ranks start once for the module and run every check in one go,
while this process runs the reference's steps.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict

from tensorflow_web_deploy_tpu import models as jax_models
from tensorflow_web_deploy_tpu.models.adapter import init_variables as jax_init
from tensorflow_web_deploy_tpu.parallel.mesh import build_mesh as jax_build_mesh
from tensorflow_web_deploy_tpu.train import create_train_state as jax_state
from tensorflow_web_deploy_tpu.train import make_train_step as jax_step
from tensorflow_web_deploy_tpu_torch.models import get as torch_get
from tensorflow_web_deploy_tpu_torch.models.adapter import read_serving_export, to_jax_params
from tensorflow_web_deploy_tpu_torch.serving.engine import InferenceEngine
from tensorflow_web_deploy_tpu_torch.train import adamw, create_train_state, make_train_step, sgd
from tensorflow_web_deploy_tpu_torch.train.checkpoint import STATE_FILE, Checkpointer
from tensorflow_web_deploy_tpu_torch.utils.config import ModelConfig, ServerConfig

from test_torch_distributed import run_ranks, worker

WIDTH, CLASSES, SIZE, BATCH, LR = 0.25, 4, 32, 8, 3e-3
ADAM_STEPS = 3
DW = "block5_0.dw.dwconv.weight"  # 240 channels: 120 a shard over 'model'

_WORKER = r"""
import json, sys
from pathlib import Path
import numpy as np, torch
torch.set_num_threads(1)
from tensorflow_web_deploy_tpu_torch.models import get
from tensorflow_web_deploy_tpu_torch.parallel import train_mesh
from tensorflow_web_deploy_tpu_torch.parallel.distributed import shutdown
from tensorflow_web_deploy_tpu_torch.train import adamw, create_train_state, make_train_step, sgd
from tensorflow_web_deploy_tpu_torch.train.checkpoint import Checkpointer
from tensorflow_web_deploy_tpu_torch.train.trainer import gather_leaf, shard_dim

out = Path(sys.argv[1])
inp = np.load(out / "inputs.npz")
flat = {k[len("flat:"):]: inp[k] for k in inp.files if k.startswith("flat:")}
x, y, x_eval = inp["x"], inp["y"], inp["x_eval"]
res, report = {}, {}


def model(dtype):
    m = get("mobilenet_v2").build(num_classes=4, width=0.25)
    return m.to(dtype)


def leaves(state, mesh, gather):
    # params, BN stats and Adam moments by name: gathered whole, or this rank's own
    opt = state["opt_state"]
    out = {}
    for name, p in state["params"].items():
        d = shard_dim(p)
        g = (lambda t: gather_leaf(t, d, mesh)) if gather and d is not None else (lambda t: t)
        out["p:" + name] = g(p.detach())
        for k in ("exp_avg", "exp_avg_sq"):
            if k in opt.state.get(p, {}):
                out[k + ":" + name] = g(opt.state[p][k])
    out.update({"s:" + k: v for k, v in state["batch_stats"].items()})
    return {k: v.detach().numpy().copy() for k, v in out.items()}


def same(a, b):
    return sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k]) for k in a)


mesh = train_mesh(2, "cpu")
rows = mesh.rows(len(x))
report["shape"] = mesh.shape

# 1. one float64 SGD step at 2 x 2
m = model(torch.float64)
state = create_train_state(m, flat, sgd(3e-3), device="cpu", mesh=mesh)
state, metrics = make_train_step(m, mesh=mesh)(state, x[rows], y[rows])
report["loss"], report["accuracy"] = float(metrics["loss"]), float(metrics["accuracy"])
report["sharded"] = sorted(n for n, p in state["params"].items() if shard_dim(p) is not None)
for name, p in state["params"].items():
    d = shard_dim(p)
    res["g:" + name] = (gather_leaf(p.grad, d, mesh) if d is not None else p.grad).numpy()
for k, v in state["batch_stats"].items():
    res["s:" + k] = v.numpy().copy()
with torch.no_grad():
    res["eval_logits"] = m.eval()(torch.as_tensor(x_eval).permute(0, 3, 1, 2)).numpy()

# 2. three float32 AdamW steps at 2 x 2, then a checkpoint
m = model(torch.float32)
state = create_train_state(m, flat, adamw(3e-3), device="cpu", mesh=mesh)
step = make_train_step(m, mesh=mesh)
for _ in range(3):
    state, _ = step(state, x[rows].astype(np.float32), y[rows])
res.update({"own:" + k: v for k, v in leaves(state, mesh, gather=False).items()})
whole = leaves(state, mesh, gather=True)
res.update({"whole:" + k: v for k, v in whole.items()})
ck = Checkpointer(str(out / "ck22"))
ck.save(3, state, mesh)
ck.wait()
report["bucket_bytes"] = step.bucket_bytes

# 3. that checkpoint restored at 4 x 1 and 1 x 4; the 1 x 1 one at 2 x 2
for name, model_axis, ckdir in (("4x1", 1, "ck22"), ("1x4", 4, "ck22"), ("2x2", 2, "ck11")):
    other = train_mesh(model_axis, "cpu")
    m = model(torch.float32)
    fresh = create_train_state(m, None, adamw(3e-3), device="cpu", mesh=other)
    # the moments exist once the optimizer has stepped
    make_train_step(m, mesh=other)(fresh, x[other.rows(len(x))].astype(np.float32),
                                   y[other.rows(len(x))])
    restored = Checkpointer(str(out / ckdir), create=False).restore(fresh, other)
    got = leaves(restored, other, gather=True)
    if ckdir == "ck22":
        want = whole
    else:
        saved = torch.load(out / ckdir / "3" / "state.pt", weights_only=True)
        order = list(restored["params"])
        want = {"p:" + k: v.numpy() for k, v in saved["params"].items()}
        for i, entry in saved["opt_state"]["state"].items():
            for k in ("exp_avg", "exp_avg_sq"):
                want[k + ":" + order[i]] = entry[k].numpy()
        want.update({"s:" + k: v.numpy() for k, v in saved["batch_stats"].items()})
    report["restored_" + name] = same(got, want)
    report["step_" + name] = int(restored["step"])
    report["sharded_" + name] = sum(shard_dim(p) is not None for p in restored["params"].values())

np.savez(out / f"rank{mesh.rank}.npz", **res)
(out / f"rank{mesh.rank}.json").write_text(json.dumps(report))
shutdown()
"""


def _x64():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    return prev


def _jax_steps(model, variables, x, y, x_eval):
    """The reference's float64 SGD step, single device and on a 2 × 2
    mesh: (loss, eval logits, batch stats by flat key) for each."""
    tx = optax.sgd(LR)
    prev = _x64()
    try:
        out = {}
        for name, mesh in (("single", None),
                           ("sharded", jax_build_mesh(jax.devices()[:4], model_axis=2))):
            v64 = jax.tree.map(lambda a: jnp.array(a, jnp.float64), variables)
            state = jax_state(model, v64, tx)
            state, m = jax_step(model, tx, mesh=mesh)(state, jnp.asarray(x), jnp.asarray(y))
            logits = model.apply({"params": state["params"], "batch_stats": state["batch_stats"]},
                                 jnp.asarray(x_eval), train=False)
            stats = {"batch_stats/" + "/".join(k): np.asarray(v)
                     for k, v in flatten_dict(state["batch_stats"]).items()}
            out[name] = (float(m["loss"]), np.asarray(logits), stats)
        return out
    finally:
        jax.config.update("jax_enable_x64", prev)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Start the 4 ranks, run the reference's steps and the port's single
    device meanwhile, and collect every rank's results."""
    out = tmp_path_factory.mktemp("sharded")
    model, variables = jax_init(jax_models.get("mobilenet_v2"), num_classes=CLASSES,
                                width=WIDTH, seed=3)
    flat = {"/".join(("params",) + k): np.asarray(v)
            for k, v in flatten_dict(variables["params"]).items()}
    flat.update({"/".join(("batch_stats",) + k): np.asarray(v)
                 for k, v in flatten_dict(variables["batch_stats"]).items()})
    rs = np.random.RandomState(0)
    x = rs.rand(BATCH, SIZE, SIZE, 3)
    y = rs.randint(0, CLASSES, BATCH).astype(np.int32)
    x_eval = rs.rand(4, SIZE, SIZE, 3)
    np.savez(out / "inputs.npz", x=x, y=y, x_eval=x_eval,
             **{"flat:" + k: v for k, v in flat.items()})
    # a 1 × 1 checkpoint (float32 AdamW, 3 steps) for the ranks to restore at 2 × 2
    single = torch_get("mobilenet_v2").build(num_classes=CLASSES, width=WIDTH)
    s11 = create_train_state(single, flat, adamw(LR), device="cpu")
    step = make_train_step(single)
    for _ in range(ADAM_STEPS):
        s11, _ = step(s11, x.astype(np.float32), y)
    ck = Checkpointer(str(out / "ck11"))
    ck.save(ADAM_STEPS, s11)
    ck.wait()

    import threading

    ranks: dict = {}

    def spawn():
        try:
            ranks["outs"] = run_ranks([worker(out, _WORKER), out], 4)
        except BaseException as e:  # raised in the fixture below
            ranks["error"] = e

    t = threading.Thread(target=spawn)
    t.start()
    try:
        ref = _jax_steps(model, variables, x, y, x_eval)
        # the port's own single-device step on the global batch, float64
        module = torch_get("mobilenet_v2").build(num_classes=CLASSES, width=WIDTH).double()
        state = create_train_state(module, flat, sgd(LR), device="cpu")
        state, m = make_train_step(module)(state, x, y)
        port1 = {"loss": float(m["loss"]),
                 "grads": {n: p.grad.numpy().copy() for n, p in module.named_parameters()}}
    finally:
        t.join()
    if "error" in ranks:
        raise ranks["error"]
    rank = [dict(np.load(out / f"rank{r}.npz")) for r in range(4)]
    report = [json.loads((out / f"rank{r}.json").read_text()) for r in range(4)]
    return {"dir": out, "ref": ref, "port1": port1, "rank": rank, "report": report,
            "flat": flat}


def test_sharded_step_loss_matches_the_references_steps(run):
    losses = [r["loss"] for r in run["report"]]
    assert len(set(losses)) == 1, losses  # the global batch's, on every rank
    assert run["report"][0]["shape"] == {"data": 2, "model": 2}
    assert DW in run["report"][0]["sharded"] and "logits.weight" in run["report"][0]["sharded"]
    for name in ("single", "sharded"):
        np.testing.assert_allclose(losses[0], run["ref"][name][0], rtol=1e-9, err_msg=name)
    np.testing.assert_allclose(losses[0], run["port1"]["loss"], rtol=1e-9)


def test_eval_logits_after_the_sharded_step_match_the_reference(run):
    for r in run["rank"]:
        np.testing.assert_array_equal(r["eval_logits"], run["rank"][0]["eval_logits"])
    for name in ("single", "sharded"):
        # f64 headroom, as the reference's test: a ×2-style bug overshoots by ~4 orders
        np.testing.assert_allclose(run["rank"][0]["eval_logits"], run["ref"][name][1],
                                   rtol=1e-4, atol=1e-6, err_msg=name)


def test_bn_running_statistics_alike_on_every_rank_and_the_single_devices(run):
    want = run["ref"]["single"][2]
    keys = [k for k in run["rank"][0] if k.startswith("s:")]
    assert len(keys) == len(want) == 2 * 52
    for k in keys:
        for r in run["rank"][1:]:
            np.testing.assert_array_equal(r[k], run["rank"][0][k], err_msg=k)
        name = k[2:]
        path, leaf = name.rsplit(".", 1)
        np.testing.assert_allclose(run["rank"][0][k],
                                   want[f"batch_stats/{path.replace('.', '/')}/{leaf}"],
                                   rtol=1e-9, atol=1e-12, err_msg=k)


def test_gradients_have_no_factor_of_the_model_axis(run):
    """Every gradient after the step's all-reduce (a sharded one gathered
    whole) against the single device's on the global batch, float64.
    ``torch.distributed.nn.functional.all_gather`` would sum the replicated
    compute's gradient over 'model': ×2 on every sharded weight."""
    single = run["port1"]["grads"]
    # a BN bias that the next train-mode BN shifts away has a true gradient
    # of 0: both sides hold rounding noise (~1e-14) there
    atol = 1e-9 * max(np.abs(g).max() for g in single.values())
    for r in run["rank"]:
        for name, g in single.items():
            np.testing.assert_allclose(r["g:" + name], g, rtol=1e-6, atol=atol, err_msg=name)
    got, want = run["rank"][0]["g:" + DW], single[DW]
    ratio = float(np.sum(got * want) / np.sum(want * want))
    assert abs(ratio - 1.0) < 1e-9, ratio


def test_adamw_leaves_identical_states_on_the_ranks_of_a_shard(run):
    """Three float32 AdamW steps at 2 × 2: each rank's own tensors (params,
    moments, BN statistics) equal, bit for bit, those of the rank that holds
    the same shard in the other data replica, and a replicated leaf equals
    on all four; the sharded ones differ between model shards."""
    own = [{k[4:]: v for k, v in r.items() if k.startswith("own:")} for r in run["rank"]]
    sharded = set(run["report"][0]["sharded"])
    for k in own[0]:
        name = k.split(":", 1)[1]
        for a, b in ((0, 2), (1, 3)):  # rank d·2 + m: the same m
            np.testing.assert_array_equal(own[a][k], own[b][k], err_msg=k)
        if name in sharded:
            assert own[0][k].shape[0] * 2 == run["rank"][0]["whole:" + k].shape[0]
        else:
            np.testing.assert_array_equal(own[0][k], own[1][k], err_msg=k)
    assert any(k.startswith("exp_avg:") for k in own[0])


def test_checkpoints_restore_across_mesh_shapes(run):
    """Saved at 2 × 2: restored whole at 1 × 1 (this process), and by the
    ranks at 4 × 1 and 1 × 4, equal bit for bit to the gathered state; the
    1 × 1 checkpoint restored at 2 × 2 equals its file."""
    for r in run["report"]:
        for shape in ("4x1", "1x4", "2x2"):
            assert r["restored_" + shape] is True, (shape, r)
            assert r["step_" + shape] == ADAM_STEPS
        assert r["sharded_4x1"] == 0 and r["sharded_1x4"] > 0 and r["sharded_2x2"] > 0
    module = torch_get("mobilenet_v2").build(num_classes=CLASSES, width=WIDTH)
    state = create_train_state(module, None, adamw(LR), device="cpu")
    rs = np.random.RandomState(1)
    make_train_step(module)(state, rs.rand(2, SIZE, SIZE, 3).astype(np.float32), [0, 1])
    restored = Checkpointer(str(run["dir"] / "ck22"), create=False).restore(state)
    whole = {k[len("whole:"):]: v for k, v in run["rank"][0].items() if k.startswith("whole:")}
    opt = restored["opt_state"]
    for name, p in restored["params"].items():
        np.testing.assert_array_equal(p.detach().numpy(), whole["p:" + name], err_msg=name)
        for k in ("exp_avg", "exp_avg_sq"):
            np.testing.assert_array_equal(opt.state[p][k].numpy(), whole[f"{k}:{name}"],
                                          err_msg=name)
    assert restored["step"] == ADAM_STEPS
    assert (run["dir"] / "ck22" / str(ADAM_STEPS) / STATE_FILE).is_file()


TOOL = ["-m", "tensorflow_web_deploy_tpu_torch.tools.train", "--model", "mobilenet_v2", "--width", "0.25", "--classes", "4", "--input-size", "32",
        "--batch", "8", "--lr", "3e-3", "--device", "cpu", "--log-every", "1",
        "--save-every", "2"]


def test_tool_trains_on_two_ranks_with_a_model_axis_and_resumes(tmp_path):
    ckdir = str(tmp_path / "run")
    first = run_ranks(TOOL + ["--steps", "2", "--model-axis", "2", "--ckpt-dir", ckdir], 2)
    assert "mesh {'data': 1, 'model': 2} over 2 ranks (gloo, cpu)" in first[0]
    assert "step 2/2 loss=" in first[0] and first[1] == ""  # rank 0 alone logs
    # resumed on the other mesh shape: 2 × 1
    second = run_ranks(TOOL + ["--steps", "3", "--model-axis", "1", "--ckpt-dir", ckdir], 2)
    assert "resumed from step 2" in second[0] and "step 3/3 loss=" in second[0]
    # the export is the gathered checkpoint's params and batch stats
    export = read_serving_export(os.path.join(ckdir, "export"))
    saved = torch.load(os.path.join(ckdir, "3", STATE_FILE), weights_only=True)
    module = torch_get("mobilenet_v2").build(num_classes=CLASSES, width=WIDTH)
    module.load_state_dict({**saved["params"], **saved["batch_stats"]}, strict=False)
    want = to_jax_params(module)
    assert sorted(export) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(export[k], v, err_msg=k)
    # and it serves in the port's engine on the CPU
    mc = ModelConfig(name="mobilenet_v2", source="native", zoo_width=WIDTH, zoo_classes=CLASSES,
                     input_size=(SIZE, SIZE), preprocess="inception", dtype="float32",
                     topk=CLASSES, ckpt_path=os.path.join(ckdir, "export"))
    eng = InferenceEngine(ServerConfig(model=mc, canvas_buckets=(48,), max_batch=8, warmup=False),
                          device="cpu")
    img = (np.random.RandomState(2).rand(SIZE, SIZE, 3) * 255).astype(np.uint8)
    scores, idx = eng.run_batch(np.stack([eng.prepare(img)[0]]), np.full((1, 2), SIZE, np.int32))
    eng.close()
    x = torch.from_numpy(img[None].astype(np.float32) / 127.5 - 1.0).permute(0, 3, 1, 2)
    with torch.no_grad():
        probs = torch.softmax(module.eval()(x), -1).numpy()[0]
    order = np.argsort(-probs)
    np.testing.assert_array_equal(idx[0], order)
    np.testing.assert_allclose(scores[0], probs[order], rtol=1e-4, atol=1e-6)
