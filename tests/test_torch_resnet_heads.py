"""The port's dilated ResNet, DANet and OCNet against the JAX package's, on
the CPU: the same numpy variables (``jax_variables``, which draws the
scalar ``gamma`` of PAM and CAM nonzero) go to both packages through the
weight bridge, in f32. Blocks, short ResNets at output stride 8 and 16
(multi-grid, deep stem), the attention modules at P >= 2048 (the flash
route, whose plain version runs on the CPU) and the four heads on
``resnet18`` at output stride 8 are held to TAP_TOL, the tolerance of
tests/test_torch_deeplab.py (rtol and atol 1e-4, atol scaled by the
largest reference value where that exceeds 1). ResNet-101 models are only
traced (``jax.eval_shape``), for their variables' names and shapes."""

import os

import jax
import numpy as np
import pytest
import torch

from segmentron_tpu.config import cfg as jax_cfg
from segmentron_tpu.models.backbones import resnet as jax_resnet
from segmentron_tpu.models.danet import CAM as JaxCAM
from segmentron_tpu.models.danet import DANet as JaxDANet
from segmentron_tpu.models.danet import PAM as JaxPAM
from segmentron_tpu.models.ocnet import OCNet as JaxOCNet
from segmentron_tpu.models.ocnet import PyramidOCModule as JaxPyramidOC
from segmentron_tpu.models.ocnet import SelfAttentionBlock as JaxSelfAttention
from segmentron_tpu_torch.config import cfg as port_cfg
from segmentron_tpu_torch.models import danet, get_segmentation_model, ocnet
from segmentron_tpu_torch.models.backbones import resnet
from segmentron_tpu_torch.ops import attention
from segmentron_tpu_torch.utils.convert import from_flax_variables
from test_torch_modules import jax_variables

torch.set_num_threads(2)

TAP_TOL = 1e-4  # tests/test_torch_deeplab.py
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _x(shape, seed=1):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _close(got, want, what=""):
    assert got.shape == want.shape, what
    atol = TAP_TOL * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=TAP_TOL, atol=atol, err_msg=what)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def _restore(cfg, snapshot):
    cfg.defrost()
    cfg.clear()
    for k, v in type(cfg)(snapshot).items():
        dict.__setitem__(cfg, k, v)


@pytest.fixture()
def cfgs():
    """Both packages' cfgs, restored afterwards."""
    snapshots = jax_cfg.to_dict(), port_cfg.to_dict()
    yield jax_cfg, port_cfg
    _restore(jax_cfg, snapshots[0])
    _restore(port_cfg, snapshots[1])


@pytest.fixture()
def flash_calls(monkeypatch):
    """Shapes of q at every call of the port's flash route."""
    calls = []
    real = attention.flash_attention
    monkeypatch.setattr(attention, "flash_attention",
                        lambda *a, **kw: calls.append(tuple(a[0].shape)) or real(*a, **kw))
    return calls


def _load(port, variables):
    port.load_state_dict(from_flax_variables(variables), strict=True)
    return port.eval()


class _NoTrainArg:
    """A flax module whose ``__call__`` takes no ``train`` flag (PAM, CAM),
    called as the ones that do."""

    def __init__(self, module):
        self.module = module

    def init(self, key, x, train):
        return self.module.init(key, x)

    def apply(self, variables, x, train):
        return self.module.apply(variables, x)


def run_module(jax_module, port_module, x, seed=0):
    """Both modules on the NHWC ``x`` with the same variables; returns the
    port's output (NHWC numpy, or a tuple of them) and the JAX one."""
    variables = jax_variables(jax_module, x, seed)
    want = jax.jit(lambda v, x: jax_module.apply(v, x, False))(variables, x)
    _load(port_module, variables)
    with torch.no_grad():
        got = port_module(torch.from_numpy(x).permute(0, 3, 1, 2))
    if isinstance(got, tuple):
        return tuple(_nhwc(g) for g in got), tuple(np.asarray(w) for w in want)
    return _nhwc(got), np.asarray(want)


# -------------------------------------------------------------- ResNet
@pytest.mark.parametrize("block,stride,dilation,prev,cin", [
    ("BasicBlock", 2, 1, 1, 16),     # stride-2 downsample
    ("BasicBlock", 1, 2, 4, 32),     # conv2 at the previous dilation
    ("Bottleneck", 2, 1, 1, 32),     # stride-2 downsample
    ("Bottleneck", 1, 2, 4, 64),     # identity skip
])
def test_resnet_blocks(block, stride, dilation, prev, cin):
    features = 16
    jax_block = getattr(jax_resnet, block)
    port_block = getattr(resnet, block)
    ds = stride != 1 or cin != features * port_block.expansion
    got, want = run_module(
        jax_block(features, stride=stride, dilation=dilation, previous_dilation=prev,
                  use_downsample=ds),
        port_block(cin, features, stride=stride, dilation=dilation, previous_dilation=prev,
                   use_downsample=ds),
        _x((2, 13, 14, cin)),
    )
    _close(got, want)


@pytest.mark.parametrize("output_stride,multi_grid,deep_stem", [
    (8, False, False), (8, True, False), (16, False, True),
])
def test_resnet_taps(output_stride, multi_grid, deep_stem):
    kw = dict(block=jax_resnet.Bottleneck, layers=(1, 1, 2, 2), output_stride=output_stride,
              deep_stem=deep_stem, stem_width=16, multi_grid=multi_grid,
              multi_dilation=(1, 2, 4))
    port = resnet.ResNet(**{**kw, "block": resnet.Bottleneck})
    taps, want = run_module(jax_resnet.ResNet(**kw), port, _x((1, 48, 40, 3)))
    for i, (got, w) in enumerate(zip(taps, want)):
        _close(got, w, f"c{i + 1}")
    assert want[3].shape[1] == -(-48 // output_stride)
    # the reference's dilation conventions, pinned on the port's own blocks
    rates = [port.layer4_0.conv2.dilation[0], port.layer4_1.conv2.dilation[0]]
    if multi_grid:
        assert rates == ([2, 4] if output_stride == 8 else [1, 2])
    elif output_stride == 8:
        assert rates == [2, 4]  # the first block of a dilation-4 stage runs at rate 2
    else:
        assert rates == [2, 2]


# ---------------------------------------------------------- attention
def test_pam_flash_route(flash_calls):
    """48 x 48 positions >= 2048: the flash route in the port, the dense
    one in JAX (its gate needs a TPU)."""
    got, want = run_module(_NoTrainArg(JaxPAM(use_pallas=True)),
                           danet.PAM(32, use_pallas=True), _x((1, 48, 48, 32)))
    assert flash_calls == [(1, 48 * 48, 4)]
    _close(got, want)


def test_self_attention_block_flash_route(flash_calls):
    got, want = run_module(
        JaxSelfAttention(key_channels=16, value_channels=32, out_channels=24, use_pallas=True),
        ocnet.SelfAttentionBlock(32, 16, 32, 24, use_pallas=True),
        _x((2, 48, 48, 32)),
    )
    assert flash_calls == [(2, 48 * 48, 16)]
    _close(got, want)


def test_cam():
    """CAM takes the softmax of max(E) - E, not of E."""
    x = _x((1, 9, 10, 24)) * 0.5
    got, want = run_module(_NoTrainArg(JaxCAM()), danet.CAM(), x)
    _close(got, want)
    cam = danet.CAM()
    with torch.no_grad():
        cam.gamma.fill_(1.0)
        flat = torch.from_numpy(x).reshape(1, 90, 24)
        energy = flat.transpose(1, 2) @ flat
        unflipped = flat @ torch.softmax(energy, -1).transpose(1, 2) + flat
        flipped = cam(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert not np.allclose(_nhwc(flipped), unflipped.reshape(1, 9, 10, 24).numpy(), atol=1e-2)


def test_pyramid_oc_padded_positions_attend(flash_calls):
    """Cells of a 10 x 11 map at levels 3 and 6 need zero padding: the
    padded positions take part in the attention of their cell with q and
    k = ConvBNReLU(0), as in the JAX module."""
    got, want = run_module(JaxPyramidOC(16, levels=(1, 3, 6)),
                           ocnet.PyramidOCModule(24, 16, levels=(1, 3, 6)),
                           _x((1, 10, 11, 24)))
    _close(got, want)
    assert flash_calls == []  # P <= 110: the dense route


# -------------------------------------------------------------- models
def _model_pair(cfgs, name, arch="base", aux=True):
    jcfg, pcfg = cfgs
    jcfg.MODEL.OUTPUT_STRIDE = 8
    pcfg.update_from_list(["MODEL.MODEL_NAME", name, "MODEL.BACKBONE", "resnet18",
                           "MODEL.OUTPUT_STRIDE", "8", "DATASET.NAME", "synthetic",
                           "SOLVER.AUX", str(aux), "MODEL.OCNet.OC_ARCH", arch])
    kw = dict(nclass=19, backbone="resnet18", aux=aux, use_pallas=True)
    jax_model = JaxDANet(**kw) if name == "DANet" else JaxOCNet(oc_arch=arch, **kw)
    return jax_model, get_segmentation_model("cpu")


@pytest.mark.parametrize("name,arch,hw", [
    ("DANet", "base", (64, 64)),
    ("OCNet", "base", (64, 64)),
    ("OCNet", "pyramid", (72, 88)),  # c4 9 x 11: every level but 1 pads its cells
    ("OCNet", "asp", (64, 64)),
])
def test_models_resnet18_os8(cfgs, name, arch, hw):
    jax_model, port = _model_pair(cfgs, name, arch)
    x = _x((1,) + hw + (3,), seed=2)
    variables = jax_variables(jax_model, x)
    want = jax.jit(lambda v, x: jax_model.apply(v, x, False))(variables, x)
    _load(port, variables)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert len(got) == len(want) == (3 if name == "DANet" else 2)
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g.numpy(), np.asarray(w), f"output {i}")


@pytest.mark.parametrize("yaml", ["cocostuff_danet_resnet101.yaml",
                                  "cocostuff_ocnet_resnet101.yaml"])
def test_resnet101_variables_load_strict(cfgs, yaml):
    """The ResNet-101 DANet (multi-grid) / OCNet of the COCO-Stuff YAMLs
    (21 classes), with aux heads: the port's model takes the JAX model's
    variables, every name and shape, with ``strict=True``. The JAX model
    is only traced."""
    from segmentron_tpu.models import get_segmentation_model as jax_model_zoo

    opts = ["SOLVER.AUX", "True"]
    for cfg in cfgs:
        cfg.update_from_file(os.path.join(REPO, "configs", yaml))
        cfg.update_from_list(opts)
    jax_model = jax_model_zoo()
    port = get_segmentation_model("cpu")
    x = np.zeros((1, 64, 64, 3), np.float32)
    shapes = jax.eval_shape(lambda: jax_model.init(jax.random.PRNGKey(0), x, False))
    variables = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    state = from_flax_variables(variables)
    want = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in state.items()} == want
    port.load_state_dict(state, strict=True)
    assert port.nclass == 21 and port.aux
    assert len({k.split(".")[1] for k in want if k.startswith("backbone.layer3_")}) == 23
