"""DeepLabv3+ / Xception-65 (2 middle blocks) in the port against the JAX
model on the same converted variables, on the CPU: the backbone's c1-c4
taps and the logits, at OS16 and OS8, with the entry through the fused
kernels' route ("block1", "stem"; their plain versions on the CPU) and
through the plain modules. The JAX model takes its unfused entry on the
CPU, which is the reference."""

import jax
import numpy as np
import pytest
import torch

from segmentron_tpu.config import cfg as jax_cfg
from segmentron_tpu.models.backbones.xception import Xception65 as JaxXception65
from segmentron_tpu.models.deeplabv3_plus import DeepLabV3Plus as JaxDeepLabV3Plus
from segmentron_tpu.modules.batch_norm import NormConfig as JaxNorm
from segmentron_tpu_torch.config import cfg as port_cfg
from segmentron_tpu_torch.models import get_segmentation_model
from segmentron_tpu_torch.models.backbones import xception as port_xception
from segmentron_tpu_torch.utils.convert import from_flax_variables
from test_torch_modules import jax_variables

torch.set_num_threads(2)

FLAGSHIP = "configs/cityscapes_deeplabv3_plus_xception65.yaml"
TAP_TOL = 1e-4  # tests/test_entrychain.py, fused vs unfused taps
LOGIT_TOL = 1e-3  # tests/test_model_parity.py, full-model logits


def _restore(cfg, snapshot):
    cfg.defrost()
    cfg.clear()
    for k, v in type(cfg)(snapshot).items():
        dict.__setitem__(cfg, k, v)


@pytest.fixture()
def flagship_cfg():
    """The port's cfg from the flagship YAML with 2 middle blocks,
    restored afterwards."""
    snapshot = port_cfg.to_dict()
    port_cfg.update_from_file(FLAGSHIP)
    port_cfg.update_from_list(["MODEL.XCEPTION.MIDDLE_BLOCKS", "2"])
    yield port_cfg
    _restore(port_cfg, snapshot)


@pytest.fixture(scope="module")
def reference():
    """{output_stride: (variables, x, taps, logits)} from the JAX model."""
    snapshot = jax_cfg.to_dict()
    out = {}
    try:
        jax_cfg.MODEL.XCEPTION.MIDDLE_BLOCKS = 2
        x = np.random.RandomState(0).randn(1, 64, 64, 3).astype(np.float32)
        v = None  # the output stride changes no variable's shape
        for os_ in (16, 8):
            jax_cfg.MODEL.OUTPUT_STRIDE = os_
            model = JaxDeepLabV3Plus(
                nclass=19, backbone="xception65", encoder_norm=JaxNorm(eps=1e-3),
                decoder_norm=JaxNorm(), output_stride=os_,
            )
            if v is None:
                v = jax_variables(model, x)
            apply = jax.jit(lambda v, x, model=model: model.apply(
                v, x, False, capture_intermediates=lambda m, method: (
                    isinstance(m, JaxXception65) and method == "__call__")))
            (logits,), inter = apply(v, x)
            taps = inter["intermediates"]["backbone"]["__call__"][0]
            out[os_] = (v, x, [np.asarray(t) for t in taps], np.asarray(logits))
    finally:
        _restore(jax_cfg, snapshot)
    return out


@pytest.mark.parametrize("os_", [16, 8])
@pytest.mark.parametrize("fused", ["block1", "stem", False])
def test_deeplab_xception65_matches_jax(reference, flagship_cfg, monkeypatch, os_, fused):
    variables, x, want_taps, want_logits = reference[os_]
    flagship_cfg.MODEL.OUTPUT_STRIDE = os_
    flagship_cfg.TPU.FUSED_STEM = fused
    calls = []
    for name in ("fused_stem", "fused_stem_block1"):
        fn = getattr(port_xception, name)
        monkeypatch.setattr(port_xception, name,
                            lambda *a, _fn=fn, _n=name, **kw: calls.append(_n) or _fn(*a, **kw))
    model = get_segmentation_model("cpu")
    model.load_state_dict(from_flax_variables(variables), strict=True)

    xt = torch.from_numpy(x)
    with torch.no_grad():
        taps = model.backbone(xt.permute(0, 3, 1, 2))
        logits = model(xt)[0]
    assert calls == ([f"fused_{'stem_block1' if fused == 'block1' else 'stem'}"] * 2
                     if fused else [])
    for i, (got, want) in enumerate(zip(taps, want_taps)):
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                                   rtol=TAP_TOL, atol=TAP_TOL, err_msg=f"c{i + 1}")
    assert logits.shape == want_logits.shape == (1, 64, 64, 19)
    scale = max(1.0, float(np.abs(want_logits).max()))
    assert float(np.abs(logits.numpy() - want_logits).max()) <= LOGIT_TOL * scale


def test_fused_entry_weights_follow_in_place_updates(flagship_cfg):
    """The backbone keeps the folded entry weights between forwards; an
    in-place change of a weight or a BN statistic must reach the next
    one."""
    from segmentron_tpu_torch.models import init_weights
    from segmentron_tpu_torch.models.backbones.xception import Xception65

    bb = init_weights(Xception65(middle_blocks=1), torch.Generator().manual_seed(0)).eval()
    x = torch.from_numpy(np.random.RandomState(1).randn(1, 3, 64, 64).astype(np.float32))
    with torch.no_grad():
        before = bb(x)[0]
        bb.block1.sep2.pw_bn.running_var.mul_(4.0)
        bb.conv1.conv.weight.mul_(0.5)
        fused = bb(x)[0]
        bb.fused_stem = False
        plain = bb(x)[0]
    np.testing.assert_allclose(fused.numpy(), plain.numpy(), rtol=TAP_TOL, atol=TAP_TOL)
    assert not np.allclose(before.numpy(), fused.numpy(), rtol=TAP_TOL, atol=TAP_TOL)
