"""The port's fused separable conv (segmentron_tpu_torch/ops/sepconv.py)
against the JAX package's, on the CPU: each entry point's plain PyTorch
version (which the wrapper takes for a CPU tensor) against the XLA
oracle and against the Pallas kernel it replaces, run in interpret mode
as tests/test_sepconv_pallas.py runs it; the int8 fold, the routing
gates, the kernel's weight packing and the weight cache."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmentron_tpu.ops import quant as jq
from segmentron_tpu.ops import sepconv as js
from segmentron_tpu_torch.ops import sepconv as ts

torch.set_num_threads(2)

F32_TOL = 2e-5  # tests/test_sepconv_pallas.py, f32 kernels vs the HIGHEST oracle
P = jax.lax.Precision.HIGHEST


def _case(seed, h, w, c, cin, co):
    """Seeded numpy arrays of one layer (float32)."""
    rng = np.random.RandomState(seed)

    def f(*s, scale=1.0):
        return (rng.randn(*s) * scale).astype(np.float32)

    def pos(k):
        return (np.abs(rng.randn(k)) + 0.3).astype(np.float32)

    return dict(
        x=f(2, h, w, c), xin_conv=f(2, h, w, cin), xin_sum=f(2, h, w, co),
        dwk=f(3, 3, 1, c, scale=0.3), pwk=f(1, 1, c, co, scale=0.2),
        a1=pos(c), b1=f(c, scale=0.1), a2=pos(co), b2=f(co, scale=0.1),
        skw=f(1, 1, cin, co, scale=0.2), sa=pos(co), sb=f(co, scale=0.1),
    )


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _oracle(t, d, stride, pre_relu, skip):
    """XLA at HIGHEST precision: the separable conv and its residual."""
    x = jnp.maximum(t["x"], 0) if pre_relu else t["x"]
    c, co = t["pwk"].shape[-2:]
    y = jax.lax.conv_general_dilated(
        x, t["dwk"], (stride, stride), [(d, d), (d, d)], rhs_dilation=(d, d),
        dimension_numbers=("NHWC", "HWIO", "NHWC"), feature_group_count=c, precision=P,
    ) * t["a1"] + t["b1"]
    y = jnp.einsum("nhwc,co->nhwo", y, t["pwk"].reshape(c, co), precision=P) * t["a2"] + t["b2"]
    if skip == "conv":
        sk = jax.lax.conv_general_dilated(
            t["xin_conv"], t["skw"], (stride, stride), [(0, 0), (0, 0)],
            dimension_numbers=("NHWC", "HWIO", "NHWC"), precision=P)
        y = y + sk * t["sa"] + t["sb"]
    elif skip == "sum":
        y = y + t["xin_sum"]
    return np.asarray(y)


@pytest.mark.parametrize("variant", ["v1", "v2"])
@pytest.mark.parametrize("h,w,c,co,d,pre_relu", [
    (16, 24, 8, 16, 2, True),   # exit-flow style dilation
    (32, 16, 16, 8, 1, False),
])
def test_fused_sepconv_matches_ref_and_pallas(h, w, c, co, d, pre_relu, variant):
    t = _case(0, h, w, c, 8, co)
    weights = (t["dwk"], t["a1"], t["b1"], t["pwk"].reshape(c, co), t["a2"], t["b2"])
    port = ts.fused_sepconv_infer if variant == "v1" else ts.fused_sepconv_infer_v2
    kernel = js.fused_sepconv_infer if variant == "v1" else js.fused_sepconv_infer_v2
    got = port(*_t(t["x"], *weights), dilation=d, pre_relu=pre_relu).numpy()
    ref = np.asarray(js.sepconv_ref(t["x"], *weights, dilation=d, pre_relu=pre_relu))
    pallas = np.asarray(kernel(t["x"], *weights, dilation=d, pre_relu=pre_relu, tile_h=8,
                               interpret=True))
    np.testing.assert_allclose(got, ref, rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(got, pallas, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("d", [1, 2])
def test_v3_matches_ref_and_pallas_fp32(d):
    t = _case(d, 32, 64, 12, 8, 16)
    weights = (t["dwk"], t["a1"], t["b1"], t["pwk"], t["a2"], t["b2"])
    got = ts.fused_sepconv_infer_v3(*_t(t["x"], *weights), dilation=d, pre_relu=True).numpy()
    pallas = np.asarray(js.fused_sepconv_infer_v3(
        t["x"], *weights, dilation=d, pre_relu=True, tile_h=8, interpret=True))
    np.testing.assert_allclose(got, _oracle(t, d, 1, True, None), rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(got, pallas, rtol=F32_TOL, atol=F32_TOL)


SKIP_CASES = [
    (2, "conv", 1, True),    # entry-block end (block2 at any output stride)
    (1, "conv", 1, True),    # entry block3 end at output stride 8
    (1, "conv", 2, False),   # dilated conv-skip
    (1, "sum", 2, True),     # middle-flow end at output stride 8
    (2, "conv", 2, True),    # strided + dilated
]


def _skip_args(t, skip):
    main = (t["dwk"], t["a1"], t["b1"], t["pwk"], t["a2"], t["b2"])
    if skip == "sum":
        return (t["x"], t["xin_sum"], *main)
    return (t["x"], t["xin_conv"], *main, t["skw"], t["sa"], t["sb"])


@pytest.mark.parametrize("stride,skip,d,pre_relu", SKIP_CASES)
def test_v3_skip_matches_ref_and_pallas_fp32(stride, skip, d, pre_relu):
    c, cin, co = (16, 16, 16) if skip == "sum" else (12, 8, 16)
    t = _case(stride * 10 + d, 32, 64, c, cin, co)
    args = _skip_args(t, skip)
    kw = dict(dilation=d, stride=stride, pre_relu=pre_relu, skip=skip)
    got = ts.fused_sepconv_infer_v3_skip(*_t(*args), **kw).numpy()
    pallas = np.asarray(js.fused_sepconv_infer_v3_skip(*args, tile_out=4, interpret=True, **kw))
    want = _oracle(t, d, stride, pre_relu, skip)
    assert got.shape == want.shape == pallas.shape
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(got, pallas, rtol=F32_TOL, atol=F32_TOL)


def test_fold_sepconv_int8_matches_jax():
    t = _case(3, 8, 8, 24, 8, 40)
    want = js.fold_sepconv_int8(t["a1"], t["b1"], t["pwk"], t["a2"], k_sigma=5.0)
    got = ts.fold_sepconv_int8(*_t(t["a1"], t["b1"], t["pwk"], t["a2"]), k_sigma=5.0)
    assert got[2].dtype == torch.int8 and tuple(got[2].shape) == (24, 40)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))  # int8 values: exact
    for g, w in zip((got[0], got[1], got[3]), (want[0], want[1], want[3])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=0)


def _int8_step(osc, wq):
    """One int8 step of the output scale: what one depthwise value
    rounding to the neighbouring int8 moves an output by, at most."""
    return float(np.max(np.abs(np.asarray(wq)).max(axis=0) * np.abs(np.asarray(osc))))


@pytest.mark.parametrize("entry", ["v3", "sum", "conv_s2"])
def test_int8_dot_matches_pallas(entry):
    """Same fold order as the Pallas kernel, so equal up to a depthwise
    value that sits within an f32 ulp of a half-integer and rounds to the
    other int8: at most one int8 step of the output scale, plus f32
    rounding of the epilogue (1e-5 relative)."""
    t = _case(7, 32, 64, 16, 8, 16)
    ms, mb, wq, osc = js.fold_sepconv_int8(t["a1"], t["b1"], t["pwk"], t["a2"])
    main = (t["dwk"], ms, mb, wq, osc, t["b2"])
    if entry == "v3":
        got = ts.fused_sepconv_infer_v3(*_t(t["x"], *main), dilation=2, pre_relu=True,
                                        int8_dot=True)
        want = js.fused_sepconv_infer_v3(t["x"], *main, dilation=2, pre_relu=True, tile_h=8,
                                         int8_dot=True, interpret=True)
    else:
        skip, stride = ("sum", 1) if entry == "sum" else ("conv", 2)
        extra = () if skip == "sum" else (t["skw"], t["sa"], t["sb"])
        args = (t["x"], t["xin_sum"] if skip == "sum" else t["xin_conv"], *main, *extra)
        kw = dict(dilation=1, stride=stride, pre_relu=True, int8_dot=True, skip=skip)
        got = ts.fused_sepconv_infer_v3_skip(*_t(*args), **kw)
        want = js.fused_sepconv_infer_v3_skip(*args, tile_out=4, interpret=True, **kw)
    want = np.asarray(want)
    err = np.abs(got.numpy() - want)
    assert err.max() <= _int8_step(osc, wq) + 1e-5 * np.abs(want).max(), err.max()
    # and nearly everywhere not even that: the roundings agree
    assert (err > 1e-5 * np.abs(want).max()).mean() < 1e-3


def test_int8_dot_matches_xla_pw_semantics():
    """The int8_dot plain version against the JAX package's unfused "pw"
    pipeline (same static ranges; the fused route folds 1/s_mid before
    the rounding, the unfused divides after it): rel < 0.05, the bar of
    tests/test_sepconv_pallas.py."""
    t = _case(7, 32, 64, 8, 8, 16)
    z = jax.lax.conv_general_dilated(
        jnp.maximum(t["x"], 0), t["dwk"], (1, 1), [(1, 1), (1, 1)],
        dimension_numbers=("NHWC", "HWIO", "NHWC"), feature_group_count=8,
        preferred_element_type=jnp.float32,
    ) * t["a1"] + t["b1"]
    q = jq.quantize_static(z, jq.bn_amax(t["a1"], t["b1"]))
    want = np.asarray(jq.qconv(q, t["pwk"], 1, 0, 1, bn_affine=(t["a2"], t["b2"])))
    ms, mb, wq, osc = ts.fold_sepconv_int8(*_t(t["a1"], t["b1"], t["pwk"], t["a2"]))
    got = ts.fused_sepconv_infer_v3(*_t(t["x"], t["dwk"]), ms, mb, wq, osc, *_t(t["b2"]),
                                    dilation=1, pre_relu=True, int8_dot=True).numpy()
    rel = float(np.abs(got - want).max() / np.abs(want).max())
    assert rel < 0.05, rel


def test_gates_match_jax():
    """The routing gates are the JAX package's formulas, value for value."""
    for h, w, c, co, d, tile in [(512, 1024, 128, 128, 1, 4), (256, 512, 256, 256, 1, 4),
                                 (64, 128, 728, 728, 1, 4), (512, 1024, 1024, 1024, 1, 8),
                                 (128, 256, 728, 728, 2, 8), (128, 256, 728, 728, 2, 4),
                                 (64, 128, 1536, 2048, 2, 4), (30, 64, 16, 16, 1, 8)]:
        assert ts.sepconv_vmem_ok(h, w, c, co, d, tile_h=tile) == \
            js.sepconv_vmem_ok(h, w, c, co, d, tile_h=tile)
        assert ts.v3_vmem_ok(h, w, c, co, d, tile) == js.v3_vmem_ok(h, w, c, co, d, tile)
        for stride, cin in [(1, c), (2, 128)]:
            assert ts.v3_skip_vmem_ok(h, w, c, cin, co, d, stride, tile) == \
                js.v3_skip_vmem_ok(h, w, c, cin, co, d, stride, tile)


@pytest.mark.parametrize("dtype,int8", [(torch.bfloat16, False), (torch.float32, False),
                                        (torch.bfloat16, True)])
def test_pack_sepconv_layout(dtype, int8):
    """Channels zero-padded to 32 in / 128 out; the product's operand
    layout: (Cop, Cp) for the tensor cores, (Cp, Cop) for f32 FMA."""
    c, cin, co = 24, 40, 136
    t = _case(5, 4, 4, c, cin, co)
    x = torch.zeros(1, 4, 4, c, dtype=dtype)
    if int8:
        ms, mb, wq, osc = ts.fold_sepconv_int8(*_t(t["a1"], t["b1"], t["pwk"], t["a2"]))
        main = (torch.from_numpy(t["dwk"]), ms, mb, wq, osc, torch.from_numpy(t["b2"]))
    else:
        main = tuple(_t(t["dwk"], t["a1"], t["b1"])) + (
            torch.from_numpy(t["pwk"]).to(dtype),) + tuple(_t(t["a2"], t["b2"]))
    packed = ts.pack_sepconv(x, *main, int8, *_t(t["skw"], t["sa"], t["sb"]))
    assert (packed.c, packed.co, packed.cin, packed.int8_dot) == (c, co, cin, int8)
    assert tuple(packed.dwp.shape) == (11, 32) and tuple(packed.osb.shape) == (2, 256)
    np.testing.assert_array_equal(packed.dwp[:9, :c].numpy(), t["dwk"].reshape(9, c))
    np.testing.assert_array_equal(packed.dwp[10, :c].numpy(), main[2].numpy())
    assert not packed.dwp[:, c:].any() and not packed.osb[:, co:].any()
    pw = main[3].reshape(c, co)
    if dtype == torch.float32:
        assert tuple(packed.pw.shape) == (32, 256) and tuple(packed.skw.shape) == (64, 256)
        assert torch.equal(packed.pw[:c, :co], pw) and not packed.pw[c:].any()
    else:
        assert packed.pw.dtype == (torch.int8 if int8 else dtype)
        assert tuple(packed.pw.shape) == (256, 32) and tuple(packed.skw.shape) == (256, 64)
        assert torch.equal(packed.pw[:co, :c], pw.t()) and not packed.pw[co:].any()
        assert not packed.pw[:, c:].any() and packed.skw.dtype == dtype
    with pytest.raises(TypeError):
        ts.pack_sepconv(x, *main[:3], main[3].to(torch.float64), *main[4:], int8)


def test_v3_skip_rejects_bad_residuals():
    t = _case(1, 8, 8, 8, 8, 16)
    args = _t(*_skip_args(t, "sum"))
    with pytest.raises(ValueError, match="stride 1"):
        ts.fused_sepconv_infer_v3_skip(*args, stride=2, skip="sum")
    with pytest.raises(ValueError, match="skip must be"):
        ts.fused_sepconv_infer_v3_skip(*args, skip="none")
    args[1] = args[1][:, :4]
    with pytest.raises(ValueError, match="x_in"):
        ts.fused_sepconv_infer_v3_skip(*args, skip="sum")


def test_wrappers_count_no_launch_on_the_cpu():
    """A launch counter moves only where a kernel is launched; a CPU
    tensor takes the plain version."""
    t = _case(2, 8, 8, 8, 8, 8)
    before = [fn.launches for fn in (ts.fused_sepconv_infer, ts.fused_sepconv_infer_v2,
                                     ts.fused_sepconv_infer_v3, ts.fused_sepconv_infer_v3_skip)]
    main = _t(t["x"], t["dwk"], t["a1"], t["b1"], t["pwk"], t["a2"], t["b2"])
    a = ts.fused_sepconv_infer(*main)
    b = ts.fused_sepconv_infer_v2(*main, tile_h=4, interpret=True)  # accepted, not read
    assert torch.equal(a, b) and torch.equal(a, ts.fused_sepconv_infer_plain(*main))
    ts.fused_sepconv_infer_v3_skip(*_t(*_skip_args(t, "sum")), skip="sum")
    assert before == [fn.launches for fn in (ts.fused_sepconv_infer, ts.fused_sepconv_infer_v2,
                                             ts.fused_sepconv_infer_v3,
                                             ts.fused_sepconv_infer_v3_skip)]


def test_weight_cache_follows_in_place_updates():
    cache, w, builds = ts.WeightCache(), torch.ones(3), []

    def build():
        builds.append(1)
        return w * 2

    assert cache.get("a", [w], build) is cache.get("a", [w], build) and len(builds) == 1
    cache.get("b", [w], build)  # another tag: its own slot
    assert len(builds) == 2
    w.mul_(3.0)  # in place: the version counter moves
    assert torch.equal(cache.get("a", [w], build), torch.full((3,), 6.0)) and len(builds) == 3
    w.data = torch.zeros(3)  # replaced storage
    assert torch.equal(cache.get("a", [w], build), torch.zeros(3)) and len(builds) == 4
