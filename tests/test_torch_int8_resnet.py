"""``TPU.INT8_RESNET`` in the port (segmentron_tpu_torch/ops/quant.py::qconv,
models/backbones/resnet.py) against the JAX package on the CPU.

- ``qconv`` at 3x3 with stride 1 and 2, dilation 1, 2 and 4, and 1x1, on
  the same ``QTensor`` and weights: bitwise equal in f32 (the int32 sums
  are exact in both, and the f32 epilogue is the same sequence of
  roundings), and so is the requantized int8 output.
- ``BasicBlock`` and ``Bottleneck`` int8 forwards in f32 at small widths:
  measured max|got - want| 1.4e-6 at max|want| ~ 7 (the f32 convs of
  conv1 and the downsample sum in other orders; no int8 value moved), so
  held at 1e-5 of max(1, max|want|).
- DANet and OCNet base over ``resnet_int8_tiny`` (Bottleneck, one block a
  stage, output stride 8), registered in both packages. There an f32
  rounding difference before a quantize sometimes moves one int8 value by
  one step, and that step spreads through every later block: at 64x64
  one value of layer2's 32,768 moved, 679 of layer4's last 32,768, and
  the JAX package's own eager and jitted DANet differ the same way (max
  0.017, mean 0.0022 |logit|; the port's mean distance from the jitted
  one is 0.0023). So a model is held to its own int8 noise:
  mean|port - JAX| <= 0.5 x mean|JAX int8 - JAX f32| (measured 0.22 and
  0.19 of it for DANet and OCNet) and the argmax agreement with the JAX
  int8 model no lower than the JAX int8 model's own with the JAX f32 one
  (measured 0.9954 against 0.9790 and 1.0 against 1.0). DANet's conv2
  planted at the previous dilation moves the mean to 14x the JAX int8
  noise (``test_parity_catches_a_planted_dilation``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import segmentron_tpu.models.backbones.resnet as jax_resnet
import segmentron_tpu.ops.quant as jq
from segmentron_tpu.config import cfg as jax_cfg
from segmentron_tpu.models.danet import DANet as JaxDANet
from segmentron_tpu.models.ocnet import OCNet as JaxOCNet
from segmentron_tpu_torch.config import cfg as port_cfg
from segmentron_tpu_torch.engine.steps import _cast_params
from segmentron_tpu_torch.models import get_segmentation_model
from segmentron_tpu_torch.models.backbones import BACKBONE_REGISTRY, resnet
from segmentron_tpu_torch.models.model_zoo import check_int8_supported
from segmentron_tpu_torch.modules import NormConfig
from segmentron_tpu_torch.ops import quant as tq
from segmentron_tpu_torch.utils.convert import from_flax_variables
from test_torch_modules import jax_variables

torch.set_num_threads(2)

BLOCK_TOL = 1e-5
MEAN_NOISE_SHARE = 0.5
K = 6.0


def _restore(cfg, snapshot):
    cfg.defrost()
    cfg.clear()
    for k, v in type(cfg)(snapshot).items():
        dict.__setitem__(cfg, k, v)


@pytest.fixture()
def cfgs():
    snapshots = jax_cfg.to_dict(), port_cfg.to_dict()
    yield jax_cfg, port_cfg
    _restore(jax_cfg, snapshots[0])
    _restore(port_cfg, snapshots[1])


def _qtensors(x, amax):
    qj = jq.quantize_static(x, amax)
    return qj, tq.QTensor(torch.from_numpy(np.array(qj.q)), torch.from_numpy(np.array(qj.scale)))


# ------------------------------------------------------------------ qconv
@pytest.mark.parametrize("k,stride,dilation", [
    (3, 1, 1), (3, 2, 1), (3, 1, 2), (3, 1, 4), (3, 2, 2), (1, 1, 1),
])
def test_qconv_bitwise_jax(k, stride, dilation):
    rng = np.random.RandomState(k * 100 + stride * 10 + dilation)
    x = rng.randn(2, 13, 11, 16).astype(np.float32)
    w = (rng.randn(k, k, 16, 24) * 0.2).astype(np.float32)
    a = rng.uniform(0.5, 1.5, 24).astype(np.float32)
    b = (rng.randn(24) * 0.1).astype(np.float32)
    qj, qt = _qtensors(x, np.full(16, 3.0, np.float32))
    pad = None if k == 3 else 0
    affine_t = (torch.from_numpy(a), torch.from_numpy(b))
    want = np.asarray(jq.qconv(qj, w, stride, pad, dilation, bn_affine=(a, b), relu=True))
    got = tq.qconv(qt, torch.from_numpy(w), stride, pad, dilation, bn_affine=affine_t,
                   relu=True)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    out_amax = np.asarray(jq.bn_amax(a, b))
    want_q = jq.qconv(qj, w, stride, pad, dilation, bn_affine=(a, b), relu=True,
                      out_amax=out_amax)
    got_q = tq.qconv(qt, torch.from_numpy(w), stride, pad, dilation, bn_affine=affine_t,
                     relu=True, out_amax=torch.from_numpy(out_amax.copy()))
    np.testing.assert_array_equal(got_q.q.numpy(), np.asarray(want_q.q))
    np.testing.assert_array_equal(got_q.scale.numpy(), np.asarray(want_q.scale))


def test_int_mm_padding_is_exact():
    """The CUDA route's padding: every shape ``torch._int_mm`` refuses is
    padded to the least legal one, the weight stays column-major, and the
    padded product cut back equals the unpadded one."""
    assert tq.int_mm_shape(17, 8, 8) == (17, 8, 8)
    assert tq.int_mm_shape(16, 8, 8) == (17, 8, 8)
    assert tq.int_mm_shape(1, 3, 5) == (17, 8, 8)
    assert tq.int_mm_shape(100, 576, 64) == (100, 576, 64)
    assert tq.int_mm_shape(100, 577, 65) == (100, 584, 72)
    rng = np.random.RandomState(0)
    for m, k, n in ((5, 12, 10), (16, 8, 8), (40, 19, 3), (33, 64, 24)):
        a = torch.from_numpy(rng.randint(-127, 128, (m, k)).astype(np.int8))
        w = torch.from_numpy(rng.randint(-127, 128, (k, n)).astype(np.int8))
        pa, pb = tq.pad_for_int_mm(a, tq.matmul_weights(w[None, None]))
        assert pa.shape[0] > 16 and pa.shape[1] % 8 == 0 and pb.shape[1] % 8 == 0
        assert pb.stride(0) == 1  # column-major
        assert (pa.shape, pb.shape) == ((max(m, 17), -(-k // 8) * 8), (-(-k // 8) * 8,
                                                                        -(-n // 8) * 8))
        want = a.long() @ w.long()
        assert torch.equal(tq.int8_matmul_acc(pa, pb)[:m, :n].long(), want)
        assert torch.equal(tq.int8_matmul_acc(a, w).long(), want)


# ----------------------------------------------------------------- blocks
def _run_block(jax_block, port_block, x, train=False):
    variables = jax_variables(jax_block, x, seed=3)
    want = np.asarray(jax.jit(lambda v, x: jax_block.apply(v, x, False))(variables, x))
    port_block.load_state_dict(from_flax_variables(variables), strict=True)
    port_block.train(train)
    with torch.no_grad():
        got = port_block(torch.from_numpy(x).permute(0, 3, 1, 2))
    return got.permute(0, 2, 3, 1).numpy(), want


@pytest.mark.parametrize("kind,stride,dilation,prev,down", [
    ("Bottleneck", 1, 1, 1, False),
    ("Bottleneck", 2, 1, 1, True),
    ("Bottleneck", 1, 2, 4, True),
    ("BasicBlock", 2, 1, 1, True),
    ("BasicBlock", 1, 4, 2, False),
])
def test_int8_blocks_match_jax(cfgs, kind, stride, dilation, prev, down):
    cfgs[0].TPU.INT8_RESNET = True
    x = np.random.RandomState(0).randn(2, 12, 10, 32).astype(np.float32)
    f = 8 if kind == "Bottleneck" else 32
    kw = dict(stride=stride, dilation=dilation, previous_dilation=prev, use_downsample=down)
    port_block = getattr(resnet, kind)(32, f, int8_k=K, **kw)
    assert port_block._int8_interior() is False  # a fresh module is in training mode
    got, want = _run_block(getattr(jax_resnet, kind)(f, **kw), port_block, x)
    assert port_block._int8_interior()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=BLOCK_TOL * max(1.0, float(np.abs(want).max())))
    port_block.int8_k = None  # the same weights on the f32 path are elsewhere
    with torch.no_grad():
        f32 = port_block(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert np.abs(f32 - want).max() > 100 * BLOCK_TOL * max(1.0, float(np.abs(want).max()))


@pytest.mark.parametrize("case", ["train", "dilation 8", "calibrate", "GroupNorm"])
def test_int8_gates_match_jax(cfgs, case):
    """Where the JAX gate sends a block down the f32 path, so does the
    port's, and both agree in f32."""
    jcfg, pcfg = cfgs
    jcfg.TPU.INT8_RESNET = True
    pcfg.update_from_list(["TPU.INT8_RESNET", "True"])
    if case == "calibrate":
        jcfg.TPU.INT8_CALIBRATE = True
        pcfg.update_from_list(["TPU.INT8_CALIBRATE", "True"])
        assert resnet.int8_resnet_k(pcfg) is None
        with pytest.raises(NotImplementedError, match="INT8_CALIBRATE"):
            check_int8_supported()
        return
    x = np.random.RandomState(1).randn(2, 10, 10, 128).astype(np.float32)
    kw = dict(dilation=8, previous_dilation=4) if case == "dilation 8" else {}
    norm_kw = dict(bn_type="GN") if case == "GroupNorm" else {}
    jax_block = jax_resnet.Bottleneck(32, **kw)
    port_block = resnet.Bottleneck(128, 32, norm=NormConfig(**norm_kw), int8_k=K, **kw)
    if case in ("train", "GroupNorm"):
        # (flax's GroupNorm variables have no bridge: the port alone, whose
        # f32 path is held to JAX by tests/test_torch_resnet_heads.py)
        xt = torch.from_numpy(x).permute(0, 3, 1, 2)
        port_block.train(case == "train")
        assert not port_block._int8_interior()
        with torch.no_grad():
            got = port_block(xt)
            port_block.int8_k = None
            torch.testing.assert_close(port_block(xt), got, rtol=0, atol=0)
        if case == "train":
            port_block.int8_k = K
            port_block.eval()
            assert port_block._int8_interior()
        return
    got, want = _run_block(jax_block, port_block, x)
    assert not port_block._int8_interior()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * max(1.0, np.abs(want).max()))
    # BasicBlock reads previous_dilation: dilation 8 with previous 4 stays int8
    basic = resnet.BasicBlock(32, 32, dilation=8, previous_dilation=4, int8_k=K).eval()
    assert basic._int8_interior() == (case == "dilation 8")


def test_bf16_cast_gives_the_jax_fold():
    """Under a bf16 predict the JAX package casts ``params`` (BN scale and
    bias to bf16, promoted to f32 in the fold) and not ``batch_stats``;
    the port's ``_cast_params`` rounds the norm affines to bf16 in f32
    storage. The fold's inputs are bitwise the same; a, c and amax differ
    only by the two libraries' f32 ``rsqrt`` (one ulp in ~35 % of
    elements, neither correctly rounded; two ulp in a after the product)."""
    rng = np.random.RandomState(4)
    block = resnet.Bottleneck(32, 8, int8_k=K)
    f32 = {}
    for name in ("bn1", "bn2", "bn3"):
        bn = getattr(block, name)
        c = bn.num_features
        f32[name] = (rng.uniform(0.5, 1.5, c).astype(np.float32),
                     (rng.randn(c) * 0.1).astype(np.float32),
                     (rng.randn(c) * 0.1).astype(np.float32),
                     rng.uniform(0.5, 1.5, c).astype(np.float32))
        with torch.no_grad():
            for t, v in zip((bn.weight, bn.bias, bn.running_mean, bn.running_var), f32[name]):
                t.copy_(torch.from_numpy(v))
    _cast_params(block, torch.bfloat16)
    assert block.conv2.weight.dtype == torch.bfloat16  # the fold reads bf16 weights, as JAX
    eps32 = np.finfo(np.float32).eps
    for name, (scale, bias, mean, var) in f32.items():
        bn = getattr(block, name)
        scale_j, bias_j = jnp.asarray(scale, jnp.bfloat16), jnp.asarray(bias, jnp.bfloat16)
        for got, want in ((bn.weight, scale_j), (bn.bias, bias_j), (bn.running_mean, mean),
                          (bn.running_var, var)):
            np.testing.assert_array_equal(got.detach().numpy(),
                                          np.asarray(want, np.float32), err_msg=name)
        a_j, c_j = (np.asarray(v) for v in jq.bn_folded_affine(scale_j, bias_j, mean, var,
                                                                bn.eps))
        a_t, c_t = (t.detach().numpy() for t in resnet._folded(bn))
        np.testing.assert_array_max_ulp(a_t, a_j, maxulp=2)
        assert np.all(np.abs(c_t - c_j) <= 2 * eps32 * (np.abs(bias) + np.abs(mean * a_j)))
        amax_t = tq.bn_amax(torch.from_numpy(a_t), torch.from_numpy(c_t), k=K).numpy()
        amax_j = np.asarray(jq.bn_amax(a_j, c_j, k=K))
        assert np.all(np.abs(amax_t - amax_j) <= 4 * eps32 * amax_j), name


# ----------------------------------------------------------------- models
@pytest.fixture()
def resnet_int8_tiny(monkeypatch):
    """``resnet_int8_tiny`` in both registries: Bottleneck, one block a
    stage, output stride 8, the port's int8 switch from its cfg."""
    tiny = dict(layers=(1, 1, 1, 1), output_stride=8)

    def jax_ctor(norm, name=None):
        return jax_resnet.ResNet(name=name, block=jax_resnet.Bottleneck, norm=norm, **tiny)

    def port_ctor(norm):
        return resnet.ResNet(block=resnet.Bottleneck, norm=norm,
                             int8_k=resnet.int8_resnet_k(port_cfg), **tiny)

    monkeypatch.setitem(jax_resnet.BACKBONE_REGISTRY._obj_map, "resnet_int8_tiny", jax_ctor)
    monkeypatch.setitem(BACKBONE_REGISTRY._obj_map, "resnet_int8_tiny", port_ctor)


_MODELS = {}


def _model_run(cfgs, name):
    """(JAX int8 logits, JAX f32 logits, the port's int8 model, input),
    once per model name."""
    if name not in _MODELS:
        jcfg, pcfg = cfgs
        jcfg.MODEL.OUTPUT_STRIDE = 8
        kw = dict(nclass=19, backbone="resnet_int8_tiny", aux=False)
        jax_model = JaxDANet(**kw) if name == "DANet" else JaxOCNet(oc_arch="base", **kw)
        x = np.random.RandomState(2).randn(1, 64, 64, 3).astype(np.float32)
        variables = jax_variables(jax_model, x)
        logits = {}
        for int8 in (True, False):
            jcfg.TPU.INT8_RESNET = int8
            fwd = jax.jit(lambda v, x: jax_model.apply(v, x, False)[0])
            logits[int8] = np.asarray(fwd(variables, x))
        _MODELS[name] = (logits[True], logits[False], from_flax_variables(variables), x)
    want, want_f32, state, x = _MODELS[name]
    cfgs[1].update_from_list([
        "MODEL.MODEL_NAME", name, "MODEL.BACKBONE", "resnet_int8_tiny", "MODEL.OUTPUT_STRIDE",
        "8", "DATASET.NAME", "synthetic", "SOLVER.AUX", "False", "TPU.INT8_RESNET", "True"])
    port = get_segmentation_model("cpu")
    port.load_state_dict(state, strict=True)
    return want, want_f32, port, x


def _parity(got, want, want_f32):
    """(mean|got - want| within its share of the JAX int8 noise, argmax
    agreement no lower than JAX int8's own with JAX f32, the numbers)."""
    noise = float(np.abs(want - want_f32).mean())
    mean = float(np.abs(got - want).mean())
    agree = float((got.argmax(-1) == want.argmax(-1)).mean())
    jax_agree = float((want.argmax(-1) == want_f32.argmax(-1)).mean())
    return mean <= MEAN_NOISE_SHARE * noise and agree >= jax_agree, (mean, noise, agree,
                                                                     jax_agree)


@pytest.mark.parametrize("name", ["DANet", "OCNet"])
def test_int8_models_match_jax(cfgs, resnet_int8_tiny, name):
    want, want_f32, port, x = _model_run(cfgs, name)
    blocks = [m for m in port.modules() if isinstance(m, resnet.Bottleneck)]
    assert len(blocks) == 4 and all(b._int8_interior() for b in blocks)
    with torch.no_grad():
        got = port(torch.from_numpy(x))[0].numpy()
        resnet.set_int8_resnet(port, None)
        got_f32 = port(torch.from_numpy(x))[0].numpy()
    ok, numbers = _parity(got, want, want_f32)
    assert ok, numbers
    scale = max(1.0, float(np.abs(want_f32).max()))
    np.testing.assert_allclose(got_f32, want_f32, rtol=1e-4, atol=1e-4 * scale)
    # the JAX package's own int8-vs-f32 agreement at this size (PERF.md)
    print(f"{name}: JAX int8 vs JAX f32 argmax agreement {numbers[3]:.6f}, port int8 vs "
          f"JAX int8 {numbers[2]:.6f}, mean|d| {numbers[0]:.3g} of noise {numbers[1]:.3g}")


def test_parity_catches_a_planted_dilation(cfgs, resnet_int8_tiny):
    """DANet's layer4_0 conv2 runs at dilation 2 after a dilation-4
    stage's convention; planted at the previous dilation (4), the int8
    model fails the parity check it passes as built."""
    want, want_f32, port, x = _model_run(cfgs, "DANet")
    conv2 = port.backbone.layer4_0.conv2
    assert conv2.dilation == (2, 2)
    conv2.dilation, conv2.padding = (4, 4), (4, 4)
    with torch.no_grad():
        bad = port(torch.from_numpy(x))[0].numpy()
    ok, numbers = _parity(bad, want, want_f32)
    assert not ok, numbers


def test_int8_resnet_builds_from_the_serving_yamls(cfgs):
    """``TPU.INT8_RESNET`` no longer raises; the serving YAMLs switch the
    blocks on with ``TPU.INT8_K``; full int8 and calibration still raise."""
    pcfg = cfgs[1]
    for yaml in ("configs/serve_cityscapes_danet_int8.yaml",
                 "configs/serve_cityscapes_ocnet_int8.yaml"):
        pcfg.update_from_file(yaml)
        assert bool(pcfg.TPU.INT8_RESNET)
        check_int8_supported()
        assert resnet.int8_resnet_k(pcfg) == float(pcfg.TPU.INT8_K)
    pcfg.update_from_list(["TPU.INT8_RESNET", "False"])
    assert resnet.int8_resnet_k(pcfg) is None
    for key, value, off in (("TPU.INT8_ACTIVATIONS", "full", "False"),
                            ("TPU.INT8_CALIBRATION_BATCHES", "2", "0")):
        pcfg.update_from_list([key, value])
        with pytest.raises(NotImplementedError, match=key.split(".")[1]):
            check_int8_supported()
        pcfg.update_from_list([key, off])
