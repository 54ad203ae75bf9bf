"""The port's train step (segmentron_tpu_torch/engine/steps.py::make_train_step)
against the JAX package's, on the CPU: DANet (aux on, MULTI_LOSS_WEIGHT
[1, 0.5, 0.5]) and OCNet base (aux on) over a short ResNet (resnet18's
blocks and widths, one block a stage, registered in both packages as
``resnet_tiny``) at output stride 8, 64x64 crops, f32, the same numpy
variables on both sides (the weight bridge), dropout off on both sides
(the two frameworks cannot draw the same bits).

With resnet18's two blocks a stage, the second dilation-4 block on the
8x8 map makes the train-mode gradients ill-conditioned: both packages'
f32 gradients then stray from a float64 run of the same step by far more
than TAP_TOL, so the test would hold rounding, not the port. Two SGD
steps at LR 0.001 (decoder 0.01): at ten times that, the JAX step's own
f32 rounding takes the CAM's input conv further than TAP_TOL from a
float64 run of the same two steps, while the port's f32 step stays close
to it. After each step the loss is held to rtol 1e-5 and the parameters
and BN statistics to TAP_TOL (tests/test_torch_resnet_heads.py: rtol and
atol 1e-4, atol scaled by the largest reference value where that exceeds
1). Then the training semantics the step relies on: BN's biased
running-variance update, FrozenBN left alone, Dropout2d's mask and scale,
and the flash route's q/k/v gradients in PAM and the OC block."""

import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import segmentron_tpu.models.backbones.resnet as jax_resnet
import segmentron_tpu.models.danet as jax_danet_mod
import segmentron_tpu.models.ocnet as jax_ocnet_mod
import segmentron_tpu.modules.module as jax_module_mod
from segmentron_tpu.config import cfg as jax_cfg
from segmentron_tpu.engine.steps import TrainState
from segmentron_tpu.engine.steps import make_train_step as jax_make_train_step
from segmentron_tpu.models.danet import DANet as JaxDANet
from segmentron_tpu.models.ocnet import OCNet as JaxOCNet
from segmentron_tpu.solver import get_lr_scheduler as jax_lr
from segmentron_tpu.solver import get_optimizer as jax_optimizer
from segmentron_tpu.solver import get_segmentation_loss as jax_loss
from segmentron_tpu_torch.config import cfg as port_cfg
from segmentron_tpu_torch.engine import make_train_step
from segmentron_tpu_torch.models import danet, get_segmentation_model, ocnet
from segmentron_tpu_torch.models.backbones import BACKBONE_REGISTRY
from segmentron_tpu_torch.models.backbones import resnet
from segmentron_tpu_torch.modules import BatchNorm2d, Dropout2d, NormConfig
from segmentron_tpu_torch.ops import attention
from segmentron_tpu_torch.solver import get_lr_scheduler, get_optimizer, get_segmentation_loss
from segmentron_tpu_torch.utils.convert import from_flax_variables
from test_torch_modules import jax_variables

torch.set_num_threads(2)

TAP_TOL = 1e-4
LOSS_RTOL = 1e-5
ITERS_PER_EPOCH = 10


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


class _NoDropout(fnn.Module):
    """The JAX package's ``Dropout2d`` with its draws switched off."""

    rate: float = 0.0

    @fnn.compact
    def __call__(self, x, train: bool = False):
        return x


@pytest.fixture()
def no_dropout(monkeypatch):
    for mod in (jax_danet_mod, jax_ocnet_mod, jax_module_mod):
        monkeypatch.setattr(mod, "Dropout2d", _NoDropout)


@pytest.fixture()
def resnet_tiny(monkeypatch):
    """``resnet_tiny`` in both packages' backbone registries: BasicBlock,
    one block a stage, output stride and multi-grid from the cfgs."""
    tiny = dict(layers=(1, 1, 1, 1), output_stride=8)

    def jax_ctor(norm, name=None):
        return jax_resnet.ResNet(name=name, block=jax_resnet.BasicBlock, norm=norm, **tiny)

    def port_ctor(norm):
        return resnet.ResNet(block=resnet.BasicBlock, norm=norm, **tiny)

    monkeypatch.setitem(jax_resnet.BACKBONE_REGISTRY._obj_map, "resnet_tiny", jax_ctor)
    monkeypatch.setitem(BACKBONE_REGISTRY._obj_map, "resnet_tiny", port_ctor)


def _close(got, want, what=""):
    assert got.shape == want.shape, what
    atol = TAP_TOL * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=TAP_TOL, atol=atol, err_msg=what)


def _batch(seed, n=2, hw=64, nclass=19):
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 256, (n, hw, hw, 3)).astype(np.uint8)
    masks = rng.randint(-1, nclass, (n, hw, hw)).astype(np.int32)
    return images, masks


def _check_state(port, state, step):
    want = from_flax_variables(jax.tree_util.tree_map(
        np.asarray, {"params": state.params, "batch_stats": state.batch_stats}))
    got = port.state_dict()
    assert set(want) == set(got)
    for key, value in want.items():
        if key.endswith("num_batches_tracked"):
            continue
        _close(got[key].numpy(), value.numpy(), f"step {step}: {key}")


@pytest.mark.parametrize("name,opts", [
    ("DANet", ["MODEL.MULTI_LOSS_WEIGHT", "[1.0, 0.5, 0.5]"]),
    ("OCNet", []),
])
def test_two_steps_match_jax(cfgs, no_dropout, resnet_tiny, name, opts):
    jcfg, pcfg = cfgs
    all_opts = ["MODEL.MODEL_NAME", name, "MODEL.BACKBONE", "resnet_tiny", "MODEL.OUTPUT_STRIDE",
                "8", "DATASET.NAME", "synthetic", "SOLVER.AUX", "True", "SOLVER.LR", "0.001",
                "TRAIN.EPOCHS", "2", *opts]
    for cfg in cfgs:
        cfg.update_from_list(all_opts)
    kw = dict(nclass=19, backbone="resnet_tiny", aux=True, use_pallas=True)
    jax_model = JaxDANet(**kw) if name == "DANet" else JaxOCNet(oc_arch="base", **kw)
    port = get_segmentation_model("cpu")
    x0, y0 = _batch(0)
    variables = jax_variables(jax_model, x0.astype(np.float32))
    port.load_state_dict(from_flax_variables(variables), strict=True)
    for m in port.modules():
        if isinstance(m, Dropout2d):
            m.rate = 0.0

    loss_kw = dict(use_ohem=False, aux=True, aux_weight=0.4, loss_name="",
                   multi_loss_weight=list(jcfg.MODEL.MULTI_LOSS_WEIGHT))
    schedule_j = jax_lr(jcfg, ITERS_PER_EPOCH)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    tx = jax_optimizer(jcfg, params, schedule_j)
    state = TrainState(step=jnp.asarray(0, jnp.int32), params=params,
                       batch_stats=jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]),
                       opt_state=tx.init(params), rng=jax.random.PRNGKey(0))
    mesh = Mesh(np.asarray(jax.devices()[:1]), ("data",))
    jax_step = jax_make_train_step(jax_model, jax_loss(name, **loss_kw), tx, mesh, donate=False)

    schedule = get_lr_scheduler(pcfg, ITERS_PER_EPOCH)
    step = make_train_step(port, get_segmentation_loss(name, **loss_kw),
                           get_optimizer(pcfg, port, schedule), schedule, device="cpu")
    assert port.training
    for i, (x, y) in enumerate((_batch(0), _batch(1))):
        state, want = jax_step(state, x, y)
        got = step(x, y)
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL, err_msg=f"step {i}")
        _check_state(port, state, i)


def test_bn_running_update_is_flax_biased():
    """Batch statistics normalize; the running variance moves toward the
    biased batch variance (flax), not torch's unbiased one; the buffers
    stay f32 for a bf16 input."""
    rng = np.random.RandomState(3)
    x = (rng.randn(2, 8, 8, 6) * 2 + 1).astype(np.float32)
    flax_bn = fnn.BatchNorm(momentum=0.9, epsilon=1e-5)
    variables = {"params": {"scale": rng.uniform(0.5, 1.5, 6).astype(np.float32),
                            "bias": rng.randn(6).astype(np.float32)},
                 "batch_stats": {"mean": rng.randn(6).astype(np.float32) * 0.1,
                                 "var": rng.uniform(0.5, 1.5, 6).astype(np.float32)}}
    want, mutated = flax_bn.apply(variables, x, use_running_average=False,
                                  mutable=["batch_stats"])
    bn = BatchNorm2d(6, eps=1e-5, momentum=0.1)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(variables["params"]["scale"]))
        bn.bias.copy_(torch.from_numpy(variables["params"]["bias"]))
        bn.running_mean.copy_(torch.from_numpy(variables["batch_stats"]["mean"]))
        bn.running_var.copy_(torch.from_numpy(variables["batch_stats"]["var"]))
    var0 = bn.running_var.clone()
    bn.train()
    got = bn(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    for key, buf in (("mean", bn.running_mean), ("var", bn.running_var)):
        np.testing.assert_allclose(buf.numpy(), np.asarray(mutated["batch_stats"][key]),
                                   rtol=1e-6, atol=1e-6, err_msg=key)
    n = x.shape[0] * x.shape[1] * x.shape[2]
    biased = x.reshape(-1, 6).var(0)
    np.testing.assert_allclose(bn.running_var.numpy(), 0.9 * var0.numpy() + 0.1 * biased,
                               rtol=1e-6)
    assert not np.allclose(bn.running_var.numpy(),
                           0.9 * var0.numpy() + 0.1 * biased * n / (n - 1), rtol=1e-4)
    bn(torch.from_numpy(x).permute(0, 3, 1, 2).to(torch.bfloat16))
    assert bn.running_mean.dtype == bn.running_var.dtype == torch.float32


def test_frozen_bn_unchanged_by_a_step():
    """FrozenBN normalizes with its running statistics in training and a
    train step leaves them as they were, while its affine trains."""
    norm = NormConfig(bn_type="FrozenBN")
    model = torch.nn.Sequential(torch.nn.Conv2d(3, 8, 3, padding=1), norm.make(8),
                                torch.nn.Conv2d(8, 4, 1))
    bn = model[1]
    with torch.no_grad():
        bn.running_mean.uniform_(-0.5, 0.5)
        bn.running_var.uniform_(0.5, 1.5)
    stats = bn.running_mean.clone(), bn.running_var.clone()
    x = torch.randn(2, 3, 8, 8, generator=torch.Generator().manual_seed(0))
    model.train()
    h = model[0](x)
    want = torch.nn.functional.batch_norm(h, *stats, bn.weight, bn.bias, False, 0.0, bn.eps)
    torch.testing.assert_close(bn(h), want)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    model(x).square().mean().backward()
    opt.step()
    torch.testing.assert_close(bn.running_mean, stats[0], rtol=0, atol=0)
    torch.testing.assert_close(bn.running_var, stats[1], rtol=0, atol=0)
    assert bn.weight.grad is not None and bn.weight.grad.abs().sum() > 0


def test_dropout2d_mask_and_scale():
    """In training whole (sample, channel) maps are zeroed or scaled by
    1/(1 - rate), drawn from the module's generator (the same generator
    state gives the same mask); the identity in eval."""
    drop = Dropout2d(0.25)
    x = torch.rand(64, 16, 5, 6) + 0.5
    drop.eval()
    assert drop(x) is x
    drop.train()
    drop.generator = torch.Generator().manual_seed(7)
    y = drop(x)
    kept = (y != 0).reshape(64, 16, -1)
    assert torch.all(kept == kept[..., :1])  # one draw per (sample, channel)
    kept = kept[..., 0][..., None, None]
    torch.testing.assert_close(y, torch.where(kept, x / 0.75, torch.zeros(())), rtol=0, atol=0)
    assert 0.6 < kept.float().mean().item() < 0.9
    drop.generator = torch.Generator().manual_seed(7)
    torch.testing.assert_close(drop(x), y)
    half = drop(x.to(torch.bfloat16))
    assert half.dtype == torch.bfloat16


def _qkv_grads(module, x):
    """Grads of the q/k/v projections of ``module`` after ``sum(out * w)``."""
    module.zero_grad(set_to_none=True)
    out = module(x)
    w = torch.from_numpy(np.random.RandomState(4).randn(*out.shape).astype(np.float32))
    (out * w).sum().backward()
    return {n: p.grad.clone() for n, p in module.named_parameters() if p.grad is not None}


@pytest.mark.parametrize("which", ["PAM", "SelfAttentionBlock"])
def test_flash_route_qkv_grads_equal_dense(monkeypatch, which):
    """P = 48 x 48 >= 2048 on narrow channels: every parameter gradient of
    the flash route (FlashAttention, the plain forward and backward on
    the CPU) equals the dense route's autograd, and the query/key/value
    projections get nonzero ones."""
    calls = []
    real = attention.flash_attention_bwd
    monkeypatch.setattr(attention, "flash_attention_bwd",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    torch.manual_seed(0)
    if which == "PAM":
        module, names = danet.PAM(32), ("query", "key", "value")
        with torch.no_grad():
            module.gamma.fill_(0.5)
    else:
        module, names = ocnet.SelfAttentionBlock(32, 16, 32, 24), ("f_query", "f_key", "f_value")
    module.train()
    x = torch.randn(2, 32, 48, 48)
    module.use_pallas = False
    dense = _qkv_grads(module, x)
    module.use_pallas = True
    flash = _qkv_grads(module, x)
    assert len(calls) == 1 and calls[0][1] == 48 * 48
    assert dense.keys() == flash.keys()
    scale = max(g.abs().max().item() for g in dense.values())
    for name, g in dense.items():  # key.bias's is 0 up to rounding: atol from all grads
        torch.testing.assert_close(flash[name], g, rtol=1e-4, atol=1e-5 * scale)
    for name in names:
        grads = [g for n, g in flash.items() if n.startswith(name + ".")]
        assert grads and all(g.abs().sum() > 0 for g in grads), name


def test_remat_and_devices(cfgs):
    """TPU.REMAT "dots" and "full" build a step (from the cfg or the
    argument), an unknown mode raises ValueError as in the JAX package;
    the step defaults to CUDA and raises without a card."""
    _, pcfg = cfgs
    model = torch.nn.Conv2d(3, 2, 1)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    pcfg.update_from_list(["TPU.REMAT", "dots"])
    assert make_train_step(model, None, opt, lambda s: 0.1, device="cpu").remat == "dots"
    assert make_train_step(model, None, opt, lambda s: 0.1, remat="full",
                           device="cpu").remat == "full"
    with pytest.raises(ValueError, match="remat"):
        make_train_step(model, None, opt, lambda s: 0.1, remat="offload", device="cpu")
    pcfg.update_from_list(["TPU.REMAT", "none"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            make_train_step(model, None, opt, lambda s: 0.1)


def test_resnet101_yaml_step_builds(cfgs):
    """The COCO-Stuff DANet YAML wires into the solver as the JAX Trainer
    wires it: one output (AUX off) and multi_weight_loss, SGD at 0.003
    with the decoder at x10, the poly schedule from step 0."""
    _, pcfg = cfgs
    pcfg.update_from_file(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "configs", "cocostuff_danet_resnet101.yaml"))
    loss = get_segmentation_loss(pcfg.MODEL.MODEL_NAME, use_ohem=pcfg.SOLVER.OHEM,
                                 aux=pcfg.SOLVER.AUX, aux_weight=pcfg.SOLVER.AUX_WEIGHT,
                                 loss_name=pcfg.SOLVER.LOSS_NAME,
                                 multi_loss_weight=list(pcfg.MODEL.MULTI_LOSS_WEIGHT))
    assert loss.func.__name__ == "multi_weight_loss" and loss.keywords["weights"] == [1, .5, .5]
    schedule = get_lr_scheduler(pcfg, 100)
    assert schedule(0) == pytest.approx(0.003)
    assert schedule(240 * 100) == 0.0
    model = torch.nn.Module()
    model.backbone = torch.nn.Conv2d(3, 4, 1)
    model.head = torch.nn.Conv2d(4, 2, 1)
    opt = get_optimizer(pcfg, model, schedule)
    assert [g["lr_factor"] for g in opt.param_groups] == [1.0, 10.0]
    assert [g["lr"] for g in opt.param_groups] == pytest.approx([0.003, 0.03])
