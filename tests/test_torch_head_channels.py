"""Two repairs of the port's heads against the JAX package, on the CPU in f32:

- ASPP ends in a channel dropout of rate 0.5 in training, as the flax
  ``ASPP`` does (``segmentron_tpu/modules/module.py``): the mask's rate and
  scale, the identity in eval, and with ``dropout=0.0`` on both sides the
  train-mode output equals the flax one on the same variables;
- the heads read their input channels from ``backbone.channels``:
  DeepLabv3+ over ``resnet18`` with its aux head, DANet and OCNet over
  ``xception65`` (2 middle blocks), at (1, 64, 64, 3), equal to the JAX
  models on the same variables.

Tolerance: TAP_TOL of tests/test_torch_deeplab.py (rtol and atol 1e-4,
atol scaled by the largest reference value where that exceeds 1), the
same f32 arithmetic in another summation order."""

import jax
import numpy as np
import pytest
import torch

from segmentron_tpu import modules as jm
from segmentron_tpu.config import cfg as jax_cfg
from segmentron_tpu.models import get_segmentation_model as jax_model_zoo
from segmentron_tpu_torch import modules as tm
from segmentron_tpu_torch.config import cfg as port_cfg
from segmentron_tpu_torch.models import get_segmentation_model
from segmentron_tpu_torch.models.backbones.xception import Xception65
from segmentron_tpu_torch.utils.convert import from_flax_variables
from test_torch_modules import jax_variables

torch.set_num_threads(2)

TAP_TOL = 1e-4  # tests/test_torch_deeplab.py


def _x(shape, seed=1):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _close(got, want, what=""):
    assert got.shape == want.shape, what
    atol = TAP_TOL * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=TAP_TOL, atol=atol, err_msg=what)


def _restore(cfg, snapshot):
    cfg.defrost()
    cfg.clear()
    for k, v in type(cfg)(snapshot).items():
        dict.__setitem__(cfg, k, v)


# ---------------------------------------------------------------- ASPP
ASPP_X = (2, 9, 10, 24)


@pytest.fixture(scope="module")
def aspp_variables():
    x = _x(ASPP_X)
    return jax_variables(jm.ASPP(16, (1, 2, 3)), x), x


def _port_aspp(variables, dropout):
    port = tm.ASPP(ASPP_X[-1], 16, (1, 2, 3), dropout=dropout)
    port.load_state_dict(from_flax_variables(variables), strict=True)
    return port


def test_aspp_has_no_dropout_parameters(aspp_variables):
    """The dropout adds no state: the flax variables load strictly and
    the state dict is the one without it."""
    variables, _ = aspp_variables
    with_drop, without = _port_aspp(variables, 0.5), _port_aspp(variables, 0.0)
    assert with_drop.dropout.rate == 0.5 and tm.ASPP(8).dropout.rate == 0.5
    assert with_drop.state_dict().keys() == without.state_dict().keys()


def test_aspp_train_drops_channels_at_half_and_scales_by_two(aspp_variables):
    """In training every (sample, channel) of the projection (a ReLU
    output) is zeroed or doubled as a whole, about half of them zeroed
    (256 draws: 0.5 +- 0.14 holds with p > 0.9999)."""
    variables, x = aspp_variables
    port = _port_aspp(variables, 0.5).train()
    xt = torch.from_numpy(np.tile(x, (8, 1, 1, 1))).permute(0, 3, 1, 2)  # 16 x 16 draws
    port.dropout.generator = torch.Generator().manual_seed(3)
    with torch.no_grad():
        got = port(xt)
        port.dropout.rate = 0.0
        base = port(xt)
    assert torch.all(base.flatten(2).amax(-1) > 0)  # ReLU leaves each channel some mass
    kept = (got.flatten(2).amax(-1) > 0)[..., None, None]
    torch.testing.assert_close(got, torch.where(kept, 2 * base, torch.zeros(())),
                               rtol=0, atol=0)
    assert 0.36 < kept.float().mean().item() < 0.64


def test_aspp_eval_is_identity_and_matches_jax(aspp_variables):
    """In eval the dropout is the identity: the port's ASPP (rate 0.5)
    equals the flax ASPP (rate 0.5) in eval."""
    variables, x = aspp_variables
    want = np.asarray(jm.ASPP(16, (1, 2, 3)).apply(variables, x, False))
    port = _port_aspp(variables, 0.5).eval()
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    _close(got.permute(0, 2, 3, 1).numpy(), want)


def test_aspp_train_without_dropout_matches_jax(aspp_variables):
    """With ``dropout=0.0`` on both sides the train-mode outputs (batch
    statistics in every BN) are equal."""
    variables, x = aspp_variables
    want, _ = jm.ASPP(16, (1, 2, 3), dropout=0.0).apply(variables, x, True,
                                                         mutable=["batch_stats"])
    port = _port_aspp(variables, 0.0).train()
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    _close(got.permute(0, 2, 3, 1).numpy(), np.asarray(want))


# -------------------------------------------------------------- models
MODELS = {
    "deeplabv3_plus_resnet18": ["MODEL.MODEL_NAME", "DeepLabV3_Plus",
                                "MODEL.BACKBONE", "resnet18"],
    "danet_xception65": ["MODEL.MODEL_NAME", "DANet", "MODEL.BACKBONE", "xception65"],
    "ocnet_xception65": ["MODEL.MODEL_NAME", "OCNet", "MODEL.BACKBONE", "xception65"],
}
COMMON = ["SOLVER.AUX", "True", "DATASET.NAME", "synthetic",
          "MODEL.XCEPTION.MIDDLE_BLOCKS", "2"]


@pytest.fixture(scope="module")
def models():
    """{name: (variables, x, JAX outputs, port model)}: each pair built
    from both packages' cfgs set alike, the JAX model compiled once."""
    snapshots = jax_cfg.to_dict(), port_cfg.to_dict()
    x = _x((1, 64, 64, 3), seed=2)
    out = {}
    try:
        for name, opts in MODELS.items():
            for cfg in (jax_cfg, port_cfg):
                cfg.update_from_list(opts + COMMON)
            jax_model = jax_model_zoo()
            variables = jax_variables(jax_model, x)
            want = jax.jit(lambda v, x, m=jax_model: m.apply(v, x, False))(variables, x)
            port = get_segmentation_model("cpu")
            out[name] = (variables, x, [np.asarray(w) for w in want], port)
            _restore(jax_cfg, snapshots[0])
            _restore(port_cfg, snapshots[1])
    finally:
        _restore(jax_cfg, snapshots[0])
        _restore(port_cfg, snapshots[1])
    return out


def test_xception65_channels_are_its_taps():
    bb = Xception65(middle_blocks=1).eval()
    with torch.no_grad():
        taps = bb(torch.zeros(1, 3, 64, 64))
    assert Xception65.channels == tuple(t.shape[1] for t in taps) == (128, 256, 728, 2048)


@pytest.mark.parametrize("name", list(MODELS))
def test_heads_on_other_backbones_match_jax(models, name):
    variables, x, want, port = models[name]
    port.load_state_dict(from_flax_variables(variables), strict=True)
    port.eval()
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert len(got) == len(want) == (3 if name.startswith("danet") else 2)
    for i, (g, w) in enumerate(zip(got, want)):
        assert w.shape == (1, 64, 64, 19)
        _close(g.numpy(), w, f"{name} output {i}")
