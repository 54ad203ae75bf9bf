"""The port's int8 "pw" serving mode and fused separable-conv routes
against the JAX package's, on the CPU: the quantization functions
(segmentron_tpu_torch/ops/quant.py), ``SeparableConv2d`` and
``XceptionBlock`` under ``USE_PALLAS_SEPCONV`` (path A) and under
``INT8_ACTIVATIONS="pw"`` with ``FUSED_SEPCONV_V3`` / ``FUSED_ENTRY_V3``
(path B) on converted weights, path B through the whole DeepLabv3+ /
Xception-65 (2 middle blocks; path A: tests/test_torch_deeplab.py), and
the refusals that remain. The JAX side runs its Pallas kernels in interpret mode
(``SEGMENTRON_PALLAS_INTERPRET=1``, set for it alone: the port does not
read it); the port's wrappers compute their plain versions."""

import jax
import numpy as np
import pytest
import torch

from segmentron_tpu import modules as jm
from segmentron_tpu.config import cfg as jax_cfg
from segmentron_tpu.models.backbones.xception import XceptionBlock as JaxXceptionBlock
from segmentron_tpu.models.deeplabv3_plus import DeepLabV3Plus as JaxDeepLabV3Plus
from segmentron_tpu.ops import quant as jq
from segmentron_tpu_torch import modules as tm
from segmentron_tpu_torch.config import cfg as port_cfg
from segmentron_tpu_torch.models import get_segmentation_model
from segmentron_tpu_torch.models.backbones import xception as port_xception
from segmentron_tpu_torch.modules import basic as port_basic
from segmentron_tpu_torch.ops import quant as tq
from segmentron_tpu_torch.utils.convert import from_flax_variables
from test_torch_deeplab import FLAGSHIP, _restore
from test_torch_modules import jax_variables, run_both

torch.set_num_threads(2)

# One int8 step of an activation moves an output by about 1/127 of its
# range, and the two packages' f32 sums differ in the last bit, so now
# and then a value rounds to the other int8: the reference's own tests
# allow rel 0.05-0.06 between its routes (tests/test_sepconv_pallas.py).
INT8_REL = 0.05


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def _rng(seed=0):
    return np.random.RandomState(seed)


@pytest.fixture()
def jax_knobs(monkeypatch):
    """Set ``TPU`` knobs on the JAX package's cfg (restored afterwards),
    with its Pallas kernels in interpret mode."""
    snapshot = jax_cfg.to_dict()
    monkeypatch.setenv("SEGMENTRON_PALLAS_INTERPRET", "1")

    def set_knobs(**knobs):
        jax_cfg.defrost()
        for k, v in knobs.items():
            jax_cfg.TPU[k] = v

    yield set_knobs
    _restore(jax_cfg, snapshot)


# ------------------------------------------------------------------- quant
def test_bn_amax_and_quantize_match_jax():
    rng = _rng(0)
    a, b = rng.randn(24).astype(np.float32), rng.randn(24).astype(np.float32) * 0.2
    x = (rng.randn(2, 5, 7, 24) * 3).astype(np.float32)
    amax_j = jq.bn_amax(a, b, k=5.0)
    amax_t = tq.bn_amax(torch.from_numpy(a), torch.from_numpy(b), k=5.0)
    np.testing.assert_allclose(amax_t.numpy(), np.asarray(amax_j), rtol=1e-6)
    want = jq.quantize_static(x, amax_j)
    got = tq.quantize_static(torch.from_numpy(x), torch.from_numpy(np.array(amax_j)))
    assert got.q.dtype == torch.int8 and isinstance(got, tq.QTensor)
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))  # int8 values: exact
    np.testing.assert_allclose(got.scale.numpy(), np.asarray(want.scale), rtol=1e-6)
    np.testing.assert_allclose(tq.dequantize(got).numpy(), np.asarray(jq.dequantize(want)),
                               rtol=1e-6)
    half = torch.tensor([[0.5, 1.5, 2.5, -0.5, -1.5, 300.0]])  # half to even, clip
    assert tq.quantize_static(half, torch.full((6,), 127.0)).q.tolist() == [[0, 2, 2, 0, -2, 127]]


@pytest.mark.parametrize("groups", [1, 12])
def test_fold_and_quantize_weights_matches_jax(groups):
    rng = _rng(1)
    shape = (1, 1, 12, 20) if groups == 1 else (3, 3, 1, 24)
    w = (rng.randn(*shape) * 0.3).astype(np.float32)
    s = rng.uniform(0.01, 0.1, 12).astype(np.float32)
    wq_j, sw_j = jq.fold_and_quantize_weights(w, s, groups)
    wq_t, sw_t = tq.fold_and_quantize_weights(torch.from_numpy(w), torch.from_numpy(s), groups)
    np.testing.assert_array_equal(wq_t.numpy(), np.asarray(wq_j))  # int8 values: exact
    np.testing.assert_allclose(sw_t.numpy(), np.asarray(sw_j), rtol=1e-6)


@pytest.mark.parametrize("requantize", [False, True])
def test_qconv_pointwise_matches_jax(requantize):
    rng = _rng(2)
    x = rng.randn(2, 6, 5, 16).astype(np.float32)
    w = (rng.randn(1, 1, 16, 24) * 0.25).astype(np.float32)
    a, b = rng.uniform(0.5, 1.5, 24).astype(np.float32), (rng.randn(24) * 0.1).astype(np.float32)
    amax = np.full(16, 3.0, np.float32)
    out_amax = np.asarray(jq.bn_amax(a, b)) if requantize else None
    want = jq.qconv(jq.quantize_static(x, amax), w, 1, 0, 1, bn_affine=(a, b), relu=True,
                    out_amax=out_amax)
    got = tq.qconv(tq.quantize_static(torch.from_numpy(x), torch.from_numpy(amax)),
                   torch.from_numpy(w), 1, 0, 1,
                   bn_affine=(torch.from_numpy(a), torch.from_numpy(b)), relu=True,
                   out_amax=None if out_amax is None else torch.from_numpy(np.array(out_amax)))
    if requantize:
        # the f32 epilogues may differ in the last bit: at most one int8 step, rarely
        diff = np.abs(got.q.numpy().astype(np.int32) - np.asarray(want.q).astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_int8_matmul_is_exact_beyond_f32():
    """127 * 127 * 2048 > 2**24: an f32 product would not be exact."""
    a = torch.full((3, 2048), 127, dtype=torch.int8)
    a[1] = -127
    a[2, ::2] = 126
    b = torch.full((2048, 2), 127, dtype=torch.int8)
    b[1::2, 1] = -125
    want = a.to(torch.int64) @ b.to(torch.int64)
    assert int(want.abs().max()) > 2 ** 24
    got = tq.int8_matmul(a, b)
    assert got.dtype == torch.float32
    assert torch.equal(got, want.to(torch.float32))  # the exact sum, rounded once to f32


def test_qconv_refuses_what_is_not_ported():
    """Grouped (depthwise) int8 convolutions are not ported; any kernel
    size, stride and dilation is (tests/test_torch_int8_resnet.py)."""
    q = tq.quantize_static(torch.zeros(1, 4, 4, 8), torch.ones(8))
    for kw in (dict(w=torch.zeros(1, 1, 1, 8), groups=8), dict(w=torch.zeros(3, 3, 4, 8), groups=2)):
        with pytest.raises(NotImplementedError):
            tq.qconv(q, **kw)


# ---------------------------------------------------------------- modules
def _count(monkeypatch, module, names, calls=None):
    """Count the calls of the fused entry points ``names`` that
    ``module`` makes (their launch counters move only on the card)."""
    calls = {} if calls is None else calls
    for name in names:
        calls[name] = 0
        fn = getattr(module, name)

        def counted(*a, _fn=fn, _n=name, **kw):
            calls[_n] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(module, name, counted)
    return calls


@pytest.mark.parametrize("relu_first,dilation", [(True, 1), (False, 2)])
def test_separable_conv_fused_route(jax_knobs, monkeypatch, relu_first, dilation):
    """``USE_PALLAS_SEPCONV``: the fused kernel route against the JAX
    module's (its v2 Pallas kernel), f32, 2e-5 as the kernels' own tests."""
    jax_knobs(USE_PALLAS_SEPCONV=True)
    calls = _count(monkeypatch, port_basic, ["fused_sepconv_infer_v2"])
    got, want = run_both(
        jm.SeparableConv2d(40, 3, dilation=dilation, relu_first=relu_first),
        tm.SeparableConv2d(32, 40, 3, dilation=dilation, relu_first=relu_first,
                           routes=tm.SepconvRoutes(fused=True)),
        _rng(1).randn(1, 16, 24, 32).astype(np.float32),
    )
    assert calls["fused_sepconv_infer_v2"] == 1
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("stride,dilation,relu_first", [(1, 1, True), (2, 1, True),
                                                        (1, 12, False)])
def test_separable_conv_int8_pw_unfused(jax_knobs, stride, dilation, relu_first):
    """The unfused "pw" route (depthwise f32 sums -> int8 -> s8 x s8
    pointwise) against the JAX module's, same order of operations."""
    jax_knobs(INT8_ACTIVATIONS="pw", INT8_K=5.0)
    got, want = run_both(
        jm.SeparableConv2d(40, 3, stride=stride, dilation=dilation, relu_first=relu_first),
        tm.SeparableConv2d(32, 40, 3, stride=stride, dilation=dilation, relu_first=relu_first,
                           routes=tm.SepconvRoutes(int8="pw", int8_k=5.0)),
        _rng(1).randn(1, 26, 30, 32).astype(np.float32),
    )
    assert _rel(got, want) < INT8_REL / 5  # same rounding points: an int8 step now and then


def test_separable_conv_int8_pw_fused_chain(jax_knobs, monkeypatch):
    """``chain=True`` under ``FUSED_SEPCONV_V3``: one call of the fused
    int8 kernel, against the JAX module's v3 Pallas kernel and against
    the port's own unfused route."""
    jax_knobs(INT8_ACTIVATIONS="pw", FUSED_SEPCONV_V3=True)
    calls = _count(monkeypatch, port_basic, ["fused_sepconv_infer_v3"])
    x = _rng(1).randn(1, 16, 24, 32).astype(np.float32)
    jax_module = jm.SeparableConv2d(40, 3, dilation=2, chain=True)
    variables = jax_variables(jax_module, x)
    want = np.asarray(jax_module.apply(variables, x, False))
    port = tm.SeparableConv2d(32, 40, 3, dilation=2,
                              routes=tm.SepconvRoutes(int8="pw", fused_v3=True)).eval()
    port.load_state_dict(from_flax_variables(variables), strict=True)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        fused = port(xt, chain=True).permute(0, 2, 3, 1).numpy()
        unfused = port(xt).permute(0, 2, 3, 1).numpy()  # chain=False: no kernel
    assert calls["fused_sepconv_infer_v3"] == 1
    assert _rel(fused, want) < INT8_REL / 5
    assert _rel(fused, unfused) < INT8_REL  # 1/s_mid folded before vs after the rounding


@pytest.mark.parametrize("skip_type", ["sum", "conv"])
def test_xception_block_fused_chain(jax_knobs, monkeypatch, skip_type):
    """A whole block as a chain of fused kernels against the JAX block's
    Pallas chain: a dilated sum-skip block under ``FUSED_SEPCONV_V3``
    with the byte gate lowered (as tests/test_sepconv_pallas.py does),
    and a stride-2 conv-skip block opted in by ``FUSED_ENTRY_V3``."""
    if skip_type == "sum":
        jax_knobs(INT8_ACTIVATIONS="pw", FUSED_SEPCONV_V3=True, FUSED_SEPCONV_MIN_BYTES=1)
        routes = tm.SepconvRoutes(int8="pw", fused_v3=True, min_bytes=1)
        jax_block = JaxXceptionBlock((16, 16, 16), 1, dilation=2, skip_type="sum",
                                     name="middle1")
        port = port_xception.XceptionBlock(16, (16, 16, 16), 1, dilation=2, skip_type="sum",
                                           routes=routes, name="middle1")
    else:
        jax_knobs(INT8_ACTIVATIONS="pw", FUSED_ENTRY_V3="block2, block3")
        routes = tm.SepconvRoutes(int8="pw", entry_v3=("block2", "block3"))
        jax_block = JaxXceptionBlock((24, 24, 24), 2, name="block2")
        port = port_xception.XceptionBlock(16, (24, 24, 24), 2, routes=routes, name="block2")
    calls = _count(monkeypatch, port_xception, ["fused_sepconv_infer_v3_skip"])
    x = _rng(2).randn(2, 32, 64, 16).astype(np.float32)
    variables = jax_variables(jax_block, x)
    want = np.asarray(jax_block.apply(variables, x, False))
    port.load_state_dict(from_flax_variables({
        "params": variables["params"], "batch_stats": variables["batch_stats"]}), strict=True)
    port.eval()
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        assert port._fused_chain(xt)
        got = port(xt).permute(0, 2, 3, 1).numpy()
        port.routes = tm.SepconvRoutes(int8="pw")  # the same block, unfused
        for i in range(3):
            getattr(port, f"sep{i + 1}").routes = port.routes
        unfused = port(xt).permute(0, 2, 3, 1).numpy()
    assert calls["fused_sepconv_infer_v3_skip"] == 1
    assert got.shape == want.shape
    assert _rel(got, want) < INT8_REL / 2
    assert _rel(got, unfused) < 0.06  # tests/test_sepconv_pallas.py, fused chain vs unfused


# ------------------------------------------------------------------ models
@pytest.fixture()
def flagship_cfg():
    """The port's cfg from the flagship YAML with 2 middle blocks,
    restored afterwards."""
    snapshot = port_cfg.to_dict()
    port_cfg.update_from_file(FLAGSHIP)
    port_cfg.update_from_list(["MODEL.XCEPTION.MIDDLE_BLOCKS", "2"])
    yield port_cfg
    _restore(port_cfg, snapshot)


def _jax_logits(os_, x):
    """(variables, logits) of the JAX DeepLabv3+/Xception-65 with 2
    middle blocks under the knobs now set on its cfg."""
    jax_cfg.MODEL.XCEPTION.MIDDLE_BLOCKS = 2
    jax_cfg.MODEL.OUTPUT_STRIDE = os_
    jax_cfg.TPU.FUSED_STEM = False  # the entry through the plain modules: not under test here
    model = JaxDeepLabV3Plus(nclass=19, backbone="xception65",
                             encoder_norm=jm.NormConfig(eps=1e-3), decoder_norm=jm.NormConfig(),
                             output_stride=os_)
    variables = jax_variables(model, x)
    logits = jax.jit(lambda v, x: model.apply(v, x, False)[0])(variables, x)
    return variables, np.asarray(logits)


def test_deeplab_path_b_matches_jax(jax_knobs, flagship_cfg, monkeypatch):
    """Path B (int8 "pw" with the fused chains, output stride 8) against
    the JAX model with its v3 kernels. The taps before the first 728-wide
    layer agree to f32 rounding; from there a value within an f32 ulp of
    a half-integer rounds to the other int8 now and then, and the ~25
    quantizers downstream amplify it: the JAX package's own fused and
    unfused routes differ by rel 0.042 in the logits of this model and
    agree on 0.953 of the argmax (measured with these inputs), so the
    port is held to rel < 0.08 and argmax agreement >= 0.90."""
    knobs = dict(INT8_ACTIVATIONS="pw", FUSED_SEPCONV_V3=True, FUSED_ENTRY_V3="block2,block3",
                 FUSED_SEPCONV_MIN_BYTES=1)
    jax_knobs(**knobs)
    x = _rng(0).randn(1, 64, 128, 3).astype(np.float32)
    variables, want = _jax_logits(8, x)
    flagship_cfg.update_from_list(
        ["MODEL.OUTPUT_STRIDE", "8", "TPU.FUSED_STEM", "False"]
        + [s for k, v in knobs.items() for s in (f"TPU.{k}", str(v))])
    calls = _count(monkeypatch, port_basic, ["fused_sepconv_infer_v2", "fused_sepconv_infer_v3"])
    _count(monkeypatch, port_xception, ["fused_sepconv_infer_v3_skip"], calls)
    model = get_segmentation_model("cpu")
    model.load_state_dict(from_flax_variables(variables), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x))[0].numpy()
    # block2, block3 and the 2 middle blocks: 2 layers + 1 block end each
    assert calls == {"fused_sepconv_infer_v2": 0, "fused_sepconv_infer_v3": 8,
                     "fused_sepconv_infer_v3_skip": 4}
    assert _rel(got, want) < 0.08
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.90


# ---------------------------------------------------------------- refusals
@pytest.mark.parametrize("key,value", [
    ("TPU.INT8_ACTIVATIONS", "full"),
    ("TPU.INT8_CALIBRATE", "True"),
    ("TPU.INT8_CALIBRATION_BATCHES", "4"),
])
def test_int8_modes_not_ported_raise(flagship_cfg, key, value):
    from segmentron_tpu_torch.data.dataloader import SyntheticSegmentation
    from segmentron_tpu_torch.engine import Evaluator

    flagship_cfg.update_from_list(["DATASET.NAME", "synthetic", "TPU.INT8_ACTIVATIONS", "pw"])
    model = get_segmentation_model("cpu")
    flagship_cfg.update_from_list([key, value])
    with pytest.raises(NotImplementedError, match=key.split(".")[1]):
        get_segmentation_model("cpu")
    with pytest.raises(NotImplementedError, match=key.split(".")[1]):
        Evaluator(model, SyntheticSegmentation(mode="testval", length=1, image_size=(64, 64)),
                  device="cpu")
