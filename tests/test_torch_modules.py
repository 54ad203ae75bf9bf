"""The port's building blocks and ops against the JAX package's, on the
CPU: the same numpy inputs, the JAX modules' variables carried over by
the weight bridge (segmentron_tpu_torch/utils/convert.py)."""

import jax
import numpy as np
import pytest
import torch

from segmentron_tpu import modules as jm
from segmentron_tpu.ops import global_avg_pool as j_gap
from segmentron_tpu.ops import resize_bilinear as j_resize
from segmentron_tpu.ops.preprocess import normalize_u8 as j_normalize
from segmentron_tpu_torch import modules as tm
from segmentron_tpu_torch.ops import global_avg_pool, normalize_u8, resize_bilinear
from segmentron_tpu_torch.utils.convert import from_flax_variables

torch.set_num_threads(2)

TOL = 1e-5


def jax_variables(module, x, seed=0):
    """Random variables for a flax module, from numpy: conv kernels
    LeCun-normal, BN scale/var in [0.5, 1.5), bias/mean ~ N(0, 0.1^2)
    (non-trivial statistics, so the BN math is exercised)."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), x, False))
    rng = np.random.RandomState(seed)

    def fill(path, s):
        name = path[-1].key
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if name in ("bias", "mean"):
            return (rng.randn(*s.shape) * 0.1).astype(np.float32)
        return (rng.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def run_both(jax_module, port_module, x, seed=0):
    """Apply both modules to the NHWC numpy ``x`` on the same weights;
    returns (port output as NHWC numpy, JAX output)."""
    variables = jax_variables(jax_module, x, seed)
    want = np.asarray(jax_module.apply(variables, x, False))
    port_module.load_state_dict(from_flax_variables(variables), strict=True)
    port_module.eval()
    with torch.no_grad():
        got = port_module(torch.from_numpy(x).permute(0, 3, 1, 2))
    return got.permute(0, 2, 3, 1).numpy(), want


def _x(shape, seed=1):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("k,stride,dilation", [(3, 1, 1), (3, 2, 1), (1, 1, 1), (3, 1, 2)])
def test_conv_bn_relu(k, stride, dilation):
    norm_j, norm_t = jm.NormConfig(eps=1e-3), tm.NormConfig(eps=1e-3)
    got, want = run_both(
        jm.ConvBNReLU(24, k, stride, dilation=dilation, norm=norm_j),
        tm.ConvBNReLU(16, 24, k, stride, dilation=dilation, norm=norm_t),
        _x((2, 17, 20, 16)),
    )
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("relu_first,stride,dilation", [
    (True, 1, 1), (False, 1, 1), (False, 1, 2), (True, 2, 1), (False, 1, 12),
])
def test_separable_conv(relu_first, stride, dilation):
    got, want = run_both(
        jm.SeparableConv2d(40, 3, stride=stride, dilation=dilation, relu_first=relu_first),
        tm.SeparableConv2d(32, 40, 3, stride=stride, dilation=dilation, relu_first=relu_first),
        _x((1, 26, 30, 32)),
    )
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("separable", [True, False])
def test_aspp(separable):
    got, want = run_both(
        jm.ASPP(out_channels=32, atrous_rates=(2, 4, 6), separable=separable),
        tm.ASPP(48, 32, (2, 4, 6), separable=separable),
        _x((1, 12, 16, 48)),
    )
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_fcn_head():
    got, want = run_both(jm.FCNHead(7), tm.FCNHead(64, 7), _x((1, 9, 11, 64)))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("src,dst,align", [
    ((16, 16), (64, 64), True), ((33, 47), (17, 65), True), ((9, 13), (32, 20), False),
])
def test_resize_bilinear(src, dst, align):
    x = _x((2,) + src + (5,))
    want = np.asarray(j_resize(x, dst, align_corners=align))
    got = resize_bilinear(torch.from_numpy(x).permute(0, 3, 1, 2), dst, align_corners=align)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=TOL, atol=TOL)


def test_global_avg_pool():
    x = _x((2, 13, 21, 6))
    want = np.asarray(j_gap(x))
    got = global_avg_pool(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.shape == (2, 6, 1, 1)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=TOL, atol=1e-6)


def test_normalize_u8():
    x = np.random.RandomState(0).randint(0, 256, (2, 8, 9, 3)).astype(np.uint8)
    mean, std = [0.485, 0.456, 0.406], [0.229, 0.224, 0.225]
    want = np.asarray(j_normalize(x, mean, std))
    got = normalize_u8(torch.from_numpy(x), mean, std).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_max_ulp(got, want, maxulp=2)
