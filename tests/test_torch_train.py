"""The port's training path (train/trainer.py, the depthwise custom VJP,
BatchNorm on batch statistics) against the JAX package on the CPU.

Small sizes: MobileNetV2 width 0.25, 4 classes, 32 px, batch 8 (the
reference's ``tests/test_train.py`` setup, seed 3). Every tolerance is
stated where it is used. The float64 comparisons run the reference with
``jax_enable_x64`` on, as its own equivalence test does: at random init the
BN-heavy backward amplifies float32 rounding by ~1e5, so only float64 bounds
the math.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict

from tensorflow_web_deploy_tpu import models as jax_models
from tensorflow_web_deploy_tpu.models.adapter import init_variables as jax_init
from tensorflow_web_deploy_tpu.models.common import ConvBN as JaxConvBN
from tensorflow_web_deploy_tpu.ops.depthwise import depthwise_conv2d as jax_dw
from tensorflow_web_deploy_tpu.train import create_train_state as jax_state
from tensorflow_web_deploy_tpu.train import make_train_step as jax_step
from tensorflow_web_deploy_tpu_torch.models import get as torch_get
from tensorflow_web_deploy_tpu_torch.models.adapter import (
    from_jax_params,
    init_variables,
    to_jax_params,
)
from tensorflow_web_deploy_tpu_torch.models.common import ConvBN
from tensorflow_web_deploy_tpu_torch.ops.depthwise import depthwise_conv2d, depthwise_kernel_grad
from tensorflow_web_deploy_tpu_torch.train import adamw, create_train_state, make_train_step, sgd

torch.set_num_threads(2)

WIDTH, CLASSES, SIZE, BATCH = 0.25, 4, 32, 8


@contextlib.contextmanager
def x64():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", prev)


def flat(tree) -> dict[str, np.ndarray]:
    return {"/".join(k): np.asarray(v) for k, v in flatten_dict(tree).items()}


def nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


def _perturbed(params: dict, seed: int) -> dict:
    """Non-trivial BN scale, bias and running statistics."""
    rs = np.random.RandomState(seed)
    out = {}
    for k, v in params.items():
        v = np.asarray(v)
        if k.endswith(("/mean", "/bias")):
            v = rs.normal(0, 0.1, v.shape).astype(v.dtype)
        elif k.endswith(("/var", "/scale")):
            v = rs.uniform(0.5, 1.5, v.shape).astype(v.dtype)
        out[k] = v
    return out


# ------------------------------------------------------------- depthwise VJP

DW_TOL = {np.float32: dict(rtol=1e-5, atol=1e-5), np.float64: dict(rtol=1e-12, atol=1e-12)}


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("size", [64, 65])
@pytest.mark.parametrize("padding", ["SAME", "VALID"])
@pytest.mark.parametrize("stride", [1, 2])
def test_depthwise_vjp_matches_the_reference(dtype, size, padding, stride):
    """Forward, dx and dk against ``jax.vjp`` of the reference's custom-VJP
    ``depthwise_conv2d`` on the same x, kernel and output cotangent."""
    rs = np.random.RandomState(size + stride)
    x = rs.uniform(-1, 1, (2, size, size, 8)).astype(dtype)
    k = rs.normal(0, 1, (3, 3, 1, 8)).astype(dtype)
    with x64():
        y_ref, vjp = jax.vjp(lambda a, b: jax_dw(a, b, (stride, stride), padding),
                             jnp.asarray(x), jnp.asarray(k))
        g = rs.normal(0, 1, y_ref.shape).astype(dtype)
        dx_ref, dk_ref = (np.asarray(a) for a in vjp(jnp.asarray(g)))
    xt = nchw(x).requires_grad_()
    kt = torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1))).requires_grad_()
    y = depthwise_conv2d(xt, kt, (stride, stride), padding)
    y.backward(nchw(g))
    tol = DW_TOL[dtype]
    np.testing.assert_allclose(nhwc(y), np.asarray(y_ref), **tol)
    np.testing.assert_allclose(nhwc(xt.grad), dx_ref, **tol)
    # dk sums 2·H'·W' products per tap: float32 keeps ~1e-6 of it
    np.testing.assert_allclose(kt.grad.numpy().transpose(2, 3, 1, 0), dk_ref,
                               **({"rtol": 1e-4, "atol": 1e-4} if dtype == np.float32 else tol))


@pytest.mark.parametrize("stride", [1, 2])
def test_depthwise_kernel_grad_accumulates_bf16_in_float32(stride):
    """bf16 x and cotangent: the window sums run in float32 (the reference's
    ``promote(x.dtype, float32)``), so before the cast dk equals the float64
    sum of the same bf16 values within float32 rounding (2e-6 relative),
    where a bf16 accumulation over 2·32·32 terms is off by ~1e-2; after the
    cast to the kernel's bf16 it is within one bf16 spacing (2⁻⁷) of the
    reference's dk."""
    rs = np.random.RandomState(stride)
    x = torch.from_numpy(rs.uniform(-1, 1, (2, 8, 64, 64)).astype(np.float32)).bfloat16()
    k = torch.from_numpy(rs.normal(0, 1, (8, 1, 3, 3)).astype(np.float32)).bfloat16()
    oh = 64 // stride
    g = torch.from_numpy(rs.normal(0, 1, (2, 8, oh, oh)).astype(np.float32)).bfloat16()
    pads = ((1, 1), (1, 1)) if stride == 1 else ((0, 1), (0, 1))
    xp = torch.nn.functional.pad(x, (pads[1][0], pads[1][1], pads[0][0], pads[0][1]))
    dk32 = depthwise_kernel_grad(xp, g, (3, 3), (stride, stride))
    assert dk32.dtype == torch.float32
    xd, gd = xp.double().numpy(), g.double().numpy()
    exact = np.stack([(xd[:, :, dh:dh + (oh - 1) * stride + 1:stride,
                          dw:dw + (oh - 1) * stride + 1:stride] * gd).sum((0, 2, 3))
                      for dh in range(3) for dw in range(3)], 1).reshape(8, 1, 3, 3)
    np.testing.assert_allclose(dk32.numpy(), exact, rtol=2e-6, atol=2e-4)
    kt = k.clone().requires_grad_()
    depthwise_conv2d(x, kt, (stride, stride), "SAME").backward(g)
    assert kt.grad.dtype == torch.bfloat16
    _, vjp = jax.vjp(lambda a, b: jax_dw(a, b, (stride, stride), "SAME"),
                     jnp.asarray(nhwc(x.float()), jnp.bfloat16),
                     jnp.asarray(k.float().numpy().transpose(2, 3, 1, 0), jnp.bfloat16))
    dk_ref = np.asarray(vjp(jnp.asarray(nhwc(g.float()), jnp.bfloat16))[1], np.float32)
    np.testing.assert_allclose(kt.grad.float().numpy().transpose(2, 3, 1, 0), dk_ref,
                               rtol=2 ** -7, atol=1e-3)


def test_serving_forward_takes_no_autograd_function():
    """Without autograd the op records nothing and is the grouped conv of
    the padded input, bit for bit (the serving path's kernels do not
    change); with it, the custom function."""
    x, k = torch.randn(1, 4, 9, 9), torch.randn(4, 1, 3, 3)
    plain = torch.nn.functional.conv2d(torch.nn.functional.pad(x, (1, 1, 1, 1)), k, groups=4)
    for mode in (torch.no_grad, torch.inference_mode):
        with mode():
            y = depthwise_conv2d(x, k)
        assert y.grad_fn is None
        assert torch.equal(y, plain)
    y = depthwise_conv2d(x, k.requires_grad_())
    assert type(y.grad_fn).__name__ == "_DepthwiseConvBackward"


# ---------------------------------------------------------- BN in training


def test_convbn_train_mode_matches_flax():
    """One ConvBN in train mode: output and updated running statistics
    against flax's ``apply(train=True, mutable=["batch_stats"])``; float32,
    rtol 1e-5 / atol 1e-5 on the output, 1e-6 on the statistics."""
    rs = np.random.RandomState(0)
    x = rs.normal(0.3, 2.0, (4, 10, 10, 8)).astype(np.float32)
    ref = JaxConvBN(16, (3, 3), act=jax.nn.relu6)
    variables = ref.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = _perturbed(flat(variables), 1)
    y_ref, mutated = ref.apply(
        {"params": {"conv": {"kernel": params["params/conv/kernel"]},
                    "bn": {"scale": params["params/bn/scale"],
                           "bias": params["params/bn/bias"]}},
         "batch_stats": {"bn": {"mean": params["batch_stats/bn/mean"],
                                "var": params["batch_stats/bn/var"]}}},
        jnp.asarray(x), train=True, mutable=["batch_stats"])
    cell = ConvBN(8, 16, (3, 3), act="relu6")
    cell.load_state_dict(from_jax_params(params))
    assert not cell.bn.training  # born in eval mode
    y = cell.train()(nchw(x))
    np.testing.assert_allclose(nhwc(y), np.asarray(y_ref), rtol=1e-5, atol=1e-5)
    stats = flat(mutated["batch_stats"])
    np.testing.assert_allclose(cell.bn.mean.numpy(), stats["bn/mean"], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(cell.bn.var.numpy(), stats["bn/var"], rtol=1e-6, atol=1e-6)
    # biased variance: F.batch_norm's unbiased update would differ by N/(N−1)
    xs = cell.conv(nchw(x)).detach().double()
    biased = xs.var(dim=(0, 2, 3), unbiased=False).numpy()
    want = 0.99 * params["batch_stats/bn/var"].astype(np.float64) + 0.01 * biased
    np.testing.assert_allclose(cell.bn.var.numpy(), want, rtol=1e-5)


@pytest.fixture(scope="module")
def reference():
    """The reference's tiny MobileNetV2 and its seeded variables (float32)."""
    model, variables = jax_init(jax_models.get("mobilenet_v2"), num_classes=CLASSES,
                                width=WIDTH, seed=3)
    return model, variables


def test_model_train_mode_matches_flax(reference):
    """The whole model in train mode: logits and every batch stat after one
    forward against flax's, in float64, rtol 1e-9 / atol 1e-12. (In float32
    the logits part by ~7e-4: at 32 px the last stages are 1 × 1, so each
    of their BNs normalizes by the spread of 8 values and magnifies the
    rounding of everything before.)"""
    model, variables = reference
    params = _perturbed(flat(variables), 2)
    x = np.random.RandomState(4).uniform(-1, 1, (BATCH, SIZE, SIZE, 3))
    with x64():
        logits_ref, mutated = jax.jit(
            lambda v, a: model.apply(v, a, train=True, mutable=["batch_stats"]))(
            jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), _unflatten(params)),
            jnp.asarray(x))
        logits_ref = np.asarray(logits_ref)
        want = {f"batch_stats/{k}": v for k, v in flat(mutated["batch_stats"]).items()}
    module = torch_get("mobilenet_v2").build(num_classes=CLASSES, width=WIDTH).double()
    module.load_state_dict(from_jax_params(params))
    logits = module.train()(nchw(x))
    np.testing.assert_allclose(logits.detach().numpy(), logits_ref, rtol=1e-9, atol=1e-12)
    got = to_jax_params(module)
    assert len(want) == 2 * 52
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-9, atol=1e-12, err_msg=k)


def _unflatten(params: dict) -> dict:
    from flax.traverse_util import unflatten_dict

    return unflatten_dict({tuple(k.split("/")): v for k, v in params.items()})


@pytest.mark.parametrize("name", ["mobilenet_v2", "resnet50"])
def test_freshly_built_module_computes_the_reference_eval_output(name):
    """A module straight from ``build`` (no ``.eval()``) serves with its
    running statistics: the reference's ``train=False`` logits (float32,
    rtol 1e-4 of the largest logit). ``init_variables`` returns it in eval
    mode."""
    spec = jax_models.get(name)
    model, variables = jax_init(spec, num_classes=CLASSES, width=WIDTH, seed=0)
    params = _perturbed(flat(variables), 5)
    x = np.random.RandomState(6).uniform(-1, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, a: model.apply(v, a, train=False))(
        _unflatten(params), jnp.asarray(x)))
    module = torch_get(name).build(num_classes=CLASSES, width=WIDTH)
    module.load_state_dict(from_jax_params(params))
    with torch.no_grad():
        got = module(nchw(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
    built, _ = init_variables(torch_get(name), num_classes=CLASSES, width=WIDTH)
    assert not any(m.training for m in built.modules())


# -------------------------------------------------------------- train step


def _jax_run(reference, tx, x, y, steps):
    """The reference's single-device ``make_train_step`` in float64:
    (per-step loss and accuracy, final params and batch stats, flat)."""
    model, variables = reference
    with x64():
        # jnp.array copies: the reference's step donates its state
        v64 = jax.tree.map(lambda a: jnp.array(a, jnp.float64), variables)
        state = jax_state(model, v64, tx)
        step = jax_step(model, tx)
        metrics = []
        for _ in range(steps):
            state, m = step(state, jnp.asarray(x), jnp.asarray(y))
            metrics.append((float(m["loss"]), float(m["accuracy"])))
        out = {**{f"params/{k}": v for k, v in flat(state["params"]).items()},
               **{f"batch_stats/{k}": v for k, v in flat(state["batch_stats"]).items()}}
    return metrics, out


@pytest.mark.parametrize("opt,steps", [("sgd", 1), ("adamw", 3)])
def test_float64_train_steps_match_the_reference(reference, opt, steps):
    """One SGD step and three AdamW steps (lr 3e-3, optax's defaults), float64:
    loss and accuracy at every step within rtol 1e-10, and every param leaf
    and batch stat after the last within rtol 1e-7 and an atol of 1e-11
    (SGD) or 1e-7 (AdamW). AdamW moves a weight by lr·m̂/(√v̂ + eps): where
    the true gradient is 0 — a BN bias whose shift the next train-mode BN
    takes out with the batch mean — the computed one is rounding noise
    (~1e-13), and both packages move the weight by lr·noise/eps, ~1e-8,
    each by its own noise. A wrong update is ≥ 1e-5 (1% of lr)."""
    rs = np.random.RandomState(0)
    x = rs.rand(BATCH, SIZE, SIZE, 3)
    y = rs.randint(0, CLASSES, BATCH).astype(np.int32)
    tx = optax.sgd(3e-3) if opt == "sgd" else optax.adamw(3e-3)
    want_metrics, want = _jax_run(reference, tx, x, y, steps)

    module = torch_get("mobilenet_v2").build(num_classes=CLASSES, width=WIDTH).double()
    factory = sgd(3e-3) if opt == "sgd" else adamw(3e-3)
    state = create_train_state(module, flat(reference[1]), factory, device="cpu")
    step = make_train_step(module)
    got_metrics = []
    for _ in range(steps):
        state, m = step(state, x, y)
        got_metrics.append((float(m["loss"]), float(m["accuracy"])))
    assert state["step"] == steps
    np.testing.assert_allclose(got_metrics, want_metrics, rtol=1e-10)
    got = to_jax_params(module)
    assert sorted(got) == sorted(want)
    atol = 1e-11 if opt == "sgd" else 1e-7
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-7, atol=atol, err_msg=k)


def test_loss_decreases_single_device():
    """The reference's ``test_loss_decreases_single_device`` on the port:
    overfitting one fixed batch for 8 steps takes the loss under 0.8× its
    first value (AdamW, lr 3e-3, float32)."""
    module, params = init_variables(torch_get("mobilenet_v2"), num_classes=CLASSES,
                                    width=WIDTH, seed=3)
    state = create_train_state(module, params, adamw(3e-3), device="cpu")
    step = make_train_step(module)
    rs = np.random.RandomState(0)
    x = rs.rand(BATCH, SIZE, SIZE, 3).astype(np.float32)
    y = rs.randint(0, CLASSES, BATCH)
    losses = []
    for _ in range(8):
        state, m = step(state, x, y)
        losses.append(float(m["loss"]))
    assert state["step"] == 8
    assert losses[-1] < losses[0] * 0.8, losses


def test_train_state_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    module = torch_get("mobilenet_v2").build(num_classes=CLASSES, width=WIDTH)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_train_state(module, None, sgd(0.1))
