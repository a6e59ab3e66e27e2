"""The port's Inception-v3 (models/) against the JAX package's flax model:
seeded init leaf by leaf, weight carry-over, float32 probabilities, and
the serving BN fold. Small size: width 0.25, 10 classes, input 96.

Both forwards run the stem through the space-to-depth rewrite
(ops/stem.py in each package), so the probability check also pins that
the two rewrites agree.
"""

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
from tensorflow_web_deploy_tpu_torch.models.common import BatchNorm, fold_bn
from tensorflow_web_deploy_tpu_torch.utils.config import ModelConfig

torch.set_num_threads(2)

WIDTH, CLASSES, SIZE = 0.25, 10, 96


@pytest.fixture(scope="module")
def jax_model():
    return jax_native("inception_v3", num_classes=CLASSES, width=WIDTH, seed=0, input_size=SIZE)


def _images(seed, n=3):
    return np.random.RandomState(seed).uniform(-1, 1, (n, SIZE, SIZE, 3)).astype(np.float32)


def test_seeded_init_equals_jax_leaf_by_leaf():
    _, variables = jax_init(jax_get("inception_v3"), num_classes=CLASSES, width=WIDTH, seed=0)
    want = {"/".join(k): np.asarray(v) for k, v in flatten_dict(variables).items()}
    module, got = init_variables(torch_get("inception_v3"), num_classes=CLASSES, width=WIDTH,
                                 seed=0)
    assert sorted(got) == sorted(want) and len(got) == 472
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the module holds exactly those values
    back = to_jax_params(module)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)


def test_from_jax_params_carries_weights(jax_model):
    rs = np.random.RandomState(3)
    # perturb every leaf so that a swapped or transposed key cannot pass
    params = {k: (np.asarray(v) + rs.normal(0, 0.01, np.shape(v))).astype(np.float32)
              for k, v in jax_model.params.items()}
    state = from_jax_params(params)
    module = torch_get("inception_v3").build(num_classes=CLASSES, width=WIDTH)
    module.load_state_dict(state)  # strict: every key present, no extras
    back = to_jax_params(module)
    assert sorted(back) == sorted(params)
    for k in params:
        np.testing.assert_array_equal(back[k], params[k], err_msg=k)
    assert tuple(state["stem1.conv.weight"].shape) == (8, 3, 3, 3)  # HWIO → OIHW
    assert tuple(state["logits.weight"].shape) == (CLASSES, params["params/logits/kernel"].shape[0])


@pytest.mark.parametrize("seed", [1, 2])
def test_f32_probabilities_match_jax(jax_model, seed):
    import jax

    rs = np.random.RandomState(seed)
    params = {k: np.asarray(v) for k, v in jax_model.params.items()}
    # non-trivial BN statistics, so that the fold and the eps are exercised
    for k in params:
        if k.endswith("/mean") or k.endswith("/bias"):
            params[k] = rs.normal(0, 0.1, params[k].shape).astype(np.float32)
        elif k.endswith("/var") or k.endswith("/scale"):
            params[k] = rs.uniform(0.5, 1.5, params[k].shape).astype(np.float32)
    x = _images(seed)
    want = np.asarray(jax.jit(jax_model.fn)(params, x)[0])
    model = native_converted("inception_v3", num_classes=CLASSES, width=WIDTH,
                             params_flat=params)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == (3, CLASSES)
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_bn_fold_is_exact():
    rs = np.random.RandomState(5)
    module, params = init_variables(torch_get("inception_v3"), num_classes=CLASSES,
                                    width=WIDTH, seed=0)
    for k in params:
        if k.endswith("/mean"):
            params[k] = rs.normal(0, 0.2, params[k].shape).astype(np.float32)
        elif k.endswith("/var"):
            params[k] = rs.uniform(0.5, 2.0, params[k].shape).astype(np.float32)
    module.load_state_dict(from_jax_params(params))
    module.eval()
    x = torch.from_numpy(_images(7).transpose(0, 3, 1, 2).copy())
    with torch.no_grad():
        before = module(x)
        after = fold_bn(module)(x)
    assert not any(isinstance(m, BatchNorm) for m in module.modules())
    torch.testing.assert_close(after, before, atol=1e-5, rtol=1e-5)


def test_unported_models_name_their_roadmap_item():
    """Every zoo model and the frozen-graph converter are ported; what the
    port refuses is a frozen graph (``source="pb"``) without its file, with
    the reference's text."""
    with pytest.raises(ValueError, match="source='pb' requires pb_path"):
        ModelConfig(name="inception_v3", source="pb")
