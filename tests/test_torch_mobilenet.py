"""The port's MobileNetV2 (models/) against the JAX package's flax model:
seeded init leaf by leaf, weight carry-over, float32 probabilities unfused
and fused, and the serving BN fold over conv and depthwise cells. Small
size: width 0.25, 10 classes, inputs 64 and 65.

Both forwards run the stride-2 stem through the space-to-depth rewrite
(ops/stem.py in each package) with the reference's "SAME" pads, which are
(0, 1) on the even input and (1, 1) on the odd one. The probability
checks at both sizes pin those pads, in the stem and in the four stride-2
depthwise cells.
"""

import jax
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from tensorflow_web_deploy_tpu.models import get as jax_get
from tensorflow_web_deploy_tpu.models.adapter import init_variables as jax_init
from tensorflow_web_deploy_tpu.models.adapter import native_converted as jax_native
from tensorflow_web_deploy_tpu_torch.models import get as torch_get
from tensorflow_web_deploy_tpu_torch.models.adapter import (
    from_jax_params,
    init_variables,
    native_converted,
    to_jax_params,
)
from tensorflow_web_deploy_tpu_torch.models.common import BatchNorm, DepthwiseConvBN, fold_bn

torch.set_num_threads(2)

WIDTH, CLASSES = 0.25, 10


@pytest.fixture(scope="module")
def jax_model():
    return jax_native("mobilenet_v2", num_classes=CLASSES, width=WIDTH, seed=0, input_size=64)


def _perturbed_bn(params, seed):
    """Non-trivial BN statistics, so that the fold and the eps are exercised."""
    rs = np.random.RandomState(seed)
    params = {k: np.asarray(v) for k, v in params.items()}
    for k in params:
        if k.endswith("/mean") or k.endswith("/bias"):
            params[k] = rs.normal(0, 0.1, params[k].shape).astype(np.float32)
        elif k.endswith("/var") or k.endswith("/scale"):
            params[k] = rs.uniform(0.5, 1.5, params[k].shape).astype(np.float32)
    return params


def test_seeded_init_equals_jax_leaf_by_leaf():
    _, variables = jax_init(jax_get("mobilenet_v2"), num_classes=CLASSES, width=WIDTH, seed=0)
    want = {"/".join(k): np.asarray(v) for k, v in flatten_dict(variables).items()}
    module, got = init_variables(torch_get("mobilenet_v2"), num_classes=CLASSES, width=WIDTH,
                                 seed=0)
    assert sorted(got) == sorted(want) and len(got) == 262
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
    module = torch_get("mobilenet_v2").build(num_classes=CLASSES, width=WIDTH)
    module.load_state_dict(state)  # strict: every key present, no extras
    back = to_jax_params(module)
    assert sorted(back) == sorted(params)
    for k in params:
        np.testing.assert_array_equal(back[k], params[k], err_msg=k)
    # HWIO [3, 3, 1, C] → [C, 1, 3, 3]: the depthwise kernel's torch layout
    assert tuple(state["block1_0.dw.dwconv.weight"].shape) == (48, 1, 3, 3)
    assert tuple(state["stem.conv.weight"].shape) == (8, 3, 3, 3)


@pytest.mark.parametrize("size", [64, 65])
@pytest.mark.parametrize("fused", [False, True])
def test_f32_probabilities_match_jax(jax_model, size, fused):
    params = _perturbed_bn(jax_model.params, size)
    x = np.random.RandomState(size).uniform(-1, 1, (3, size, size, 3)).astype(np.float32)
    ref = jax_native("mobilenet_v2", num_classes=CLASSES, width=WIDTH, seed=0, input_size=size)
    want = np.asarray(jax.jit(ref.fn)(params, x)[0])
    model = native_converted("mobilenet_v2", num_classes=CLASSES, width=WIDTH,
                             params_flat=params, fused_dw=fused)
    assert sum(m.fused for m in model.modules() if isinstance(m, DepthwiseConvBN)) == 17 * fused
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == (3, CLASSES)
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_bn_fold_is_exact_including_depthwise_cells(jax_model):
    module = torch_get("mobilenet_v2").build(num_classes=CLASSES, width=WIDTH)
    module.load_state_dict(from_jax_params(_perturbed_bn(jax_model.params, 5)))
    module.eval()
    x = torch.from_numpy(np.random.RandomState(7).uniform(-1, 1, (3, 3, 65, 65))
                         .astype(np.float32))
    with torch.no_grad():
        before = module(x)
        after = fold_bn(module)(x)
    assert not any(isinstance(m, BatchNorm) for m in module.modules())
    assert module.block1_0.dw.dwconv.bias is not None
    # exact up to float rounding, which 17 blocks accumulate: no logit moves
    # by more than 1e-5 of the largest, no probability by more than 1e-5
    assert float((after - before).abs().max()) <= 1e-5 * float(before.abs().max())
    torch.testing.assert_close(after.softmax(-1), before.softmax(-1), atol=1e-5, rtol=0)
