"""The port's depthwise ops (ops/depthwise.py, ops/fused_dw.py) against the
JAX package's on the same seeded inputs, float32, on the CPU.

- the fused kernel's plain version against the Pallas kernel
  ``fused_dw_call`` run interpreted, on pre-padded input: rtol/atol 1e-5,
  the bar of tests/test_quant.py (same taps, same order; XLA may fuse a
  multiply-add where torch rounds twice);
- ``fused_depthwise_bn`` against the reference's ``impl="xla"`` at stride
  1 and 2, on an even and an odd input: the odd one pins the reference's
  asymmetric "SAME" pads;
- the fused kernel's plain version at stride 2 against the reference's
  ``impl="xla"`` (its ``_shift_mac``) at 12, 13, 64 and 65 px, and the
  stride-2 fused path routed through ``fused_dw``;
- the kernel's launch rule on every MobileNetV2 depthwise shape;
- ``DepthwiseConvBN`` fused and unfused on one parameter set.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from tensorflow_web_deploy_tpu.ops.depthwise import depthwise_conv2d as jax_dwconv
from tensorflow_web_deploy_tpu.ops.depthwise import fused_depthwise_bn as jax_fused
from tensorflow_web_deploy_tpu.ops.pallas_depthwise import fused_dw_call
from tensorflow_web_deploy_tpu_torch.models.common import DepthwiseConvBN, fold_bn
from tensorflow_web_deploy_tpu_torch.ops import depthwise as port_depthwise
from tensorflow_web_deploy_tpu_torch.ops.depthwise import (
    depthwise_conv2d,
    fused_depthwise,
    fused_depthwise_bn,
    kernel_taps,
    same_pads,
)
from tensorflow_web_deploy_tpu_torch.ops.fused_dw import (
    MAX_GROUPS,
    MAX_THREADS,
    SMEM_BUDGET,
    VEC,
    fused_dw,
    fused_dw_call_plain,
    fused_dw_plain,
    launch_shape,
)

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def _dw_inputs(rs, b, h, w, c):
    x = rs.randn(b, h, w, c).astype(np.float32)
    k = rs.randn(3, 3, 1, c).astype(np.float32)  # HWIO, as the reference holds it
    s = (0.5 + rs.rand(c)).astype(np.float32)
    t = rs.randn(c).astype(np.float32)
    return x, k, s, t


def _torch_kernel(k):
    return torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))  # [C, 1, kh, kw]


@pytest.mark.parametrize("c", [8, 24, 40])
@pytest.mark.parametrize("relu6", [True, False])
def test_plain_matches_pallas_interpret(c, relu6):
    rs = np.random.RandomState(c)
    xp = (rs.randn(2, 11, 9, c) * 2).astype(np.float32)
    taps = rs.randn(9, c).astype(np.float32)
    bias = rs.randn(1, c).astype(np.float32)
    want = np.asarray(fused_dw_call(xp, taps, bias, kh=3, kw=3, relu6=relu6, interpret=True))
    got = fused_dw_call_plain(torch.from_numpy(xp), torch.from_numpy(taps),
                              torch.from_numpy(bias), 3, 3, relu6).numpy()
    assert got.shape == (2, 9, 7, c)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("size", [12, 13])
@pytest.mark.parametrize("relu6", [True, False])
def test_fused_depthwise_bn_matches_jax(stride, size, relu6):
    rs = np.random.RandomState(size * 10 + stride)
    x, k, s, t = _dw_inputs(rs, 2, size, size, 16)
    want = np.asarray(jax_fused(x, k, s, t, strides=(stride, stride), relu6=relu6, impl="xla"))
    launches = fused_dw.launches
    got = fused_depthwise_bn(_nchw(x), _torch_kernel(k), torch.from_numpy(s),
                             torch.from_numpy(t), strides=(stride, stride), relu6=relu6)
    assert fused_dw.launches == launches  # the CPU runs the plain version
    np.testing.assert_allclose(_nhwc(got), want, **TOL)


@pytest.mark.parametrize("size", [12, 13, 64, 65])
@pytest.mark.parametrize("c", [8, 24])
@pytest.mark.parametrize("relu6", [True, False])
def test_stride2_plain_matches_jax_shift_mac(size, c, relu6):
    """The kernel's plain version at stride 2 on the reference's pads ((0, 1)
    on an even input, (1, 1) on an odd one) against the reference's XLA
    path, which runs ``_shift_mac``."""
    rs = np.random.RandomState(size * 100 + c + relu6)
    x, k, s, t = _dw_inputs(rs, 2, size, size, c)
    want = np.asarray(jax_fused(x, k, s, t, strides=(2, 2), relu6=relu6, impl="xla"))
    taps = kernel_taps(_torch_kernel(k) * torch.from_numpy(s)[:, None, None, None])
    pads = (same_pads(size, 3, 2),) * 2
    got = fused_dw_plain(_nchw(x), taps, torch.from_numpy(t).reshape(1, -1), 3, 3, pads, relu6,
                         stride=2)
    assert got.shape == (2, c, -(-size // 2), -(-size // 2))
    np.testing.assert_allclose(_nhwc(got), want, **TOL)


@pytest.mark.parametrize("size", [12, 13])
def test_stride2_fused_path_goes_through_fused_dw(size, monkeypatch):
    calls = []

    def recording(*args, **kwargs):
        calls.append((args[4:], kwargs))
        return fused_dw(*args, **kwargs)

    monkeypatch.setattr(port_depthwise, "fused_dw", recording)
    rs = np.random.RandomState(size)
    x = torch.from_numpy(rs.randn(1, 16, size, size).astype(np.float32))
    taps = torch.from_numpy(rs.randn(9, 16).astype(np.float32))
    bias = torch.from_numpy(rs.randn(1, 16).astype(np.float32))
    got = fused_depthwise(x, taps, bias, (3, 3), strides=(2, 2))
    pads = (same_pads(size, 3, 2),) * 2
    assert calls == [((3, pads, True, 2), {})]
    assert torch.equal(got, fused_dw_plain(x, taps, bias, 3, 3, pads, True, 2))
    with pytest.raises(ValueError, match="one stride"):
        fused_depthwise(x, taps, bias, (3, 3), strides=(1, 2))


# every depthwise cell of full-width MobileNetV2 at 224: (C, H, stride)
MOBILENET_V2_DW = [(32, 112, 1), (96, 112, 2), (144, 56, 1), (144, 56, 2), (192, 28, 1),
                   (192, 28, 1), (192, 28, 2), (384, 14, 1), (384, 14, 1), (384, 14, 1),
                   (384, 14, 1), (576, 14, 1), (576, 14, 1), (576, 14, 2), (960, 7, 1),
                   (960, 7, 1), (960, 7, 1)]


@pytest.mark.parametrize("b", [1, 8, 32])
@pytest.mark.parametrize("elt", [2, 4])
def test_launch_shape_covers_every_layer(b, elt):
    """The launch rule's tiling fits the kernel's limits and covers each
    output once; at batch 8 in bf16 every layer gets 2 blocks per SM."""
    assert len(MOBILENET_V2_DW) == 17
    for c, h, stride in MOBILENET_V2_DW:
        o = -(-h // stride)
        shape = launch_shape(b, c, o, o, stride, elt, sms=132)
        th, tw, cb = shape.tile()
        assert 1 <= shape.groups <= MAX_GROUPS and c % cb == 0 and cb == VEC * shape.groups
        assert shape.threads <= MAX_THREADS and shape.smem(stride, elt) <= SMEM_BUDGET
        gx, gy, gz = shape.grid(b, c, o, o)
        assert gx * cb == b * c and (gy - 1) * th < o <= gy * th and (gz - 1) * tw < o <= gz * tw
        if b >= 8 and elt == 2:
            assert shape.blocks(b, c, o, o) >= 2 * 132, (c, h, stride, shape)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("size", [12, 13])
def test_depthwise_conv2d_matches_jax(stride, size):
    rs = np.random.RandomState(size + stride)
    x, k, _, _ = _dw_inputs(rs, 2, size, size, 8)
    want = np.asarray(jax_dwconv(jnp.asarray(x), jnp.asarray(k), (stride, stride), "SAME"))
    got = depthwise_conv2d(_nchw(x), _torch_kernel(k), (stride, stride), "SAME")
    np.testing.assert_allclose(_nhwc(got), want, **TOL)


def test_same_pads_follow_lax():
    for size in (7, 12, 13, 64, 65, 224, 299):
        for k in (1, 2, 3, 5):
            for stride in (1, 2, 3):
                want = lax.padtype_to_pads((size,), (k,), (stride,), "SAME")[0]
                assert same_pads(size, k, stride) == tuple(want), (size, k, stride)
    assert same_pads(224, 3, 2) == (0, 1) and same_pads(65, 3, 2) == (1, 1)


@pytest.mark.parametrize("stride", [1, 2])
def test_fused_and_unfused_cell_agree_on_one_parameter_set(stride):
    rs = np.random.RandomState(stride)
    cell = DepthwiseConvBN(16, stride=stride)
    state = {"dwconv.weight": torch.from_numpy(rs.randn(16, 1, 3, 3).astype(np.float32)),
             "bn.scale": torch.from_numpy(rs.uniform(0.5, 1.5, 16).astype(np.float32)),
             "bn.bias": torch.from_numpy(rs.normal(0, 0.2, 16).astype(np.float32)),
             "bn.mean": torch.from_numpy(rs.normal(0, 0.2, 16).astype(np.float32)),
             "bn.var": torch.from_numpy(rs.uniform(0.5, 2.0, 16).astype(np.float32))}
    cell.load_state_dict(state)
    x = torch.from_numpy(rs.randn(2, 16, 13, 13).astype(np.float32))
    with torch.no_grad():
        unfused = cell(x)
        cell.fused = True
        fused = cell(x)
        fold_bn(cell)
        folded_fused = cell(x)
        cell.fused = False
        folded_unfused = cell(x)
    assert unfused.shape == (2, 16, 13 // stride + 13 % stride, 13 // stride + 13 % stride)
    assert float(unfused.max()) > 0 and float(unfused.min()) == 0  # relu6 clamps
    for got in (fused, folded_fused, folded_unfused):
        torch.testing.assert_close(got, unfused, **TOL)


def test_fused_dw_checks_its_inputs():
    x = torch.zeros(1, 8, 5, 5)
    taps, bias = torch.zeros(9, 8), torch.zeros(1, 8)
    with pytest.raises(ValueError, match="taps"):
        fused_dw(x, torch.zeros(9, 16), bias, 3, 3, ((1, 1), (1, 1)))
    with pytest.raises(ValueError, match="window"):
        fused_dw(torch.zeros(1, 8, 1, 1), taps, bias, 3, 3, ((0, 0), (0, 0)))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        fused_dw(x.to("meta"), taps.to("meta"), bias.to("meta"), 3, 3, ((1, 1), (1, 1)))
    with pytest.raises(ValueError, match="stride"):
        fused_dw(x, taps, bias, 3, 3, ((1, 1), (1, 1)), stride=3)
    y = fused_dw(x.to(torch.bfloat16), taps, bias, 3, 3, ((1, 1), (1, 1)))
    assert y.dtype == torch.bfloat16 and y.shape == (1, 8, 5, 5)
    assert fused_dw(x, taps, bias, 3, 3, ((0, 1), (1, 1)), stride=2).shape == (1, 8, 2, 3)


@pytest.mark.cuda
def test_fused_dw_kernel_matches_plain_on_card():
    """Runs on a machine with a CUDA card and nvcc (chip_smoke.py covers
    every full-width layer shape): stride 1 and 2, even and odd sizes, the
    reference's SAME pads."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    rs = np.random.RandomState(0)
    for (h, w), stride, dtype, relu6 in itertools.product(
            ((9, 11), (12, 12), (13, 13)), (1, 2), (torch.float32, torch.bfloat16), (True, False)):
        x = torch.from_numpy(rs.randn(2, 24, h, w).astype(np.float32)).cuda().to(dtype)
        x = x.contiguous(memory_format=torch.channels_last)
        taps = torch.from_numpy(rs.randn(9, 24).astype(np.float32)).cuda()
        bias = torch.from_numpy(rs.randn(1, 24).astype(np.float32)).cuda()
        pads = (same_pads(h, 3, stride), same_pads(w, 3, stride))
        got = fused_dw(x, taps, bias, 3, 3, pads, relu6, stride)
        ref = fused_dw_plain(x, taps, bias, 3, 3, pads, relu6, stride)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, ref, atol=0, rtol=0)
