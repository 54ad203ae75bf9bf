"""The flagship's train step in the port (DeepLabv3+ / Xception-65, 2
middle blocks, output stride 16, the YAML's OHEM, the train augmentation
on the device) against the JAX package's, on the CPU; ``TPU.REMAT``;
the eval step.

Two steps of ``make_train_step(..., augment=DeviceAugment)`` against
the JAX ``make_train_step`` on a one-device mesh, in f32, on the same
variables (the weight bridge) and the same device-augment batches
(batch 4 of 128x128 crops from 96x128 synthetic sources), dropout off
on both sides (the two frameworks cannot draw the same bits), OHEM with
``SOLVER.OHEM_MIN_KEPT`` 20000 of the 65536 pixels. After each step the
loss is held to rtol 1e-5 and the parameters and BN statistics to
TAP_TOL (rtol and atol 1e-4, atol scaled by the largest reference value
where that exceeds 1), as tests/test_torch_train_step.py holds DANet and
OCNet, and at its LR, 0.001 (decoder 0.01): at the YAML's 0.01 the
train-mode gradients of this small net are ill-conditioned, and each
package's f32 update strays from a float64 step of the port at the same
weights by several per cent of a leaf's largest update (measured on the
first step: the JAX package's 17.6 % at ``head.b3.pointwise``, the
port's 5.9 %; at ``exit_sep3.pointwise`` 6.1 % and 7.7 %), so TAP_TOL
would hold rounding, not the port. The first step is held as above. The
second runs on the first's updated weights, whose f32 rounding this net
amplifies: the port's own f32 run at 1, 2 and 4 CPU threads (the same
math summed in other orders) gives second losses 3.198677, 3.199520 and
3.198842 (float64: 3.198599, the JAX package: 3.198816) and parameters
and statistics up to 1.29e-3 of max(1, |leaf|) apart, the JAX package's
0.80e-3 to 1.24e-3 from them. So after the second step the loss is held
to rtol UPDATED_LOSS_RTOL (1e-3) and the parameters and statistics to
UPDATED_TOL (3e-3, scaled as TAP_TOL).

``TPU.REMAT`` "dots" and "full" are held to "none" with dropout on
(ASPP's ``Dropout2d(0.5)``): the loss, every gradient, the updated
parameters and the BN running statistics bitwise, the CPU running the
same kernels in the same order in each mode.
"""

import contextlib
import copy

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from torch.utils.checkpoint import CheckpointPolicy

import segmentron_tpu.data._native as jax_native
import segmentron_tpu.modules.module as jax_module_mod
from segmentron_tpu.config import cfg as jax_cfg
from segmentron_tpu.data.dataloader.synthetic import SyntheticSegmentation as JaxSynthetic
from segmentron_tpu.data.device_input import DeviceInput as JaxDeviceInput
from segmentron_tpu.engine.steps import TrainState
from segmentron_tpu.engine.steps import make_eval_step as jax_make_eval_step
from segmentron_tpu.engine.steps import make_train_step as jax_make_train_step
from segmentron_tpu.models.deeplabv3_plus import DeepLabV3Plus as JaxDeepLabV3Plus
from segmentron_tpu.modules.batch_norm import NormConfig as JaxNorm
from segmentron_tpu.ops.preprocess import DeviceAugment as JaxDeviceAugment
from segmentron_tpu.solver import get_lr_scheduler as jax_lr
from segmentron_tpu.solver import get_optimizer as jax_optimizer
from segmentron_tpu.solver import get_segmentation_loss as jax_loss
from segmentron_tpu_torch.config import cfg as port_cfg
from segmentron_tpu_torch.engine import make_eval_step, make_train_step, steps
from segmentron_tpu_torch.models import get_segmentation_model
from segmentron_tpu_torch.modules import Dropout2d
from segmentron_tpu_torch.ops.preprocess import DeviceAugment
from segmentron_tpu_torch.solver import get_lr_scheduler, get_optimizer, get_segmentation_loss
from segmentron_tpu_torch.utils.convert import from_flax_variables
from test_torch_modules import jax_variables

torch.set_num_threads(2)

FLAGSHIP = "configs/cityscapes_deeplabv3_plus_xception65.yaml"
TAP_TOL = 1e-4
LOSS_RTOL = 1e-5
# after an update: the f32 rounding noise of one step (see the docstring)
UPDATED_LOSS_RTOL = 1e-3
UPDATED_TOL = 3e-3
ITERS_PER_EPOCH = 10
CROP, BATCH, SOURCE = 128, 4, (96, 128)
OPTS = ["MODEL.XCEPTION.MIDDLE_BLOCKS", "2", "DATASET.NAME", "synthetic", "TRAIN.EPOCHS", "2",
        "TRAIN.CROP_SIZE", str(CROP), "TRAIN.BASE_SIZE", str(CROP), "SOLVER.OHEM_MIN_KEPT",
        "20000", "TPU.COMPUTE_DTYPE", "float32", "SOLVER.LR", "0.001"]
LOSS_KW = dict(use_ohem=True, aux=False, aux_weight=0.4, loss_name="", ohem_thresh=0.7,
               ohem_min_kept=20000)


def _restore(cfg, snapshot):
    cfg.defrost()
    cfg.clear()
    for k, v in type(cfg)(snapshot).items():
        dict.__setitem__(cfg, k, v)


@contextlib.contextmanager
def _flagship(cfg):
    snapshot = cfg.to_dict()
    cfg.update_from_file(FLAGSHIP)
    cfg.update_from_list(OPTS)
    try:
        yield cfg
    finally:
        _restore(cfg, snapshot)


@pytest.fixture()
def pcfg():
    with _flagship(port_cfg) as cfg:
        yield cfg


class _NoDropout(fnn.Module):
    """The JAX package's ``Dropout2d`` with its draws switched off."""

    rate: float = 0.0

    @fnn.compact
    def __call__(self, x, train: bool = False):
        return x


def _device_batches(n_batches):
    """``n_batches`` device-augment batch dicts from the JAX package's
    host side (the port's is held equal to it in test_torch_train_data)."""
    ds = JaxSynthetic(split="train", mode="train", length=BATCH * n_batches, image_size=SOURCE)
    ds.device_input = JaxDeviceInput(ds, canvas=SOURCE)
    items = [ds[i][0] for i in range(len(ds))]
    return [{k: np.stack([it[k] for it in items[b * BATCH:(b + 1) * BATCH]]) for k in items[0]}
            for b in range(n_batches)], ds.device_input.pad_label


@pytest.fixture(scope="module")
def reference():
    """Two JAX train steps: (variables before, [(loss, params, stats)],
    batches, pad label), and the JAX eval step's confusion matrix."""
    with pytest.MonkeyPatch.context() as mp, _flagship(jax_cfg) as jcfg:
        mp.setattr(jax_native, "_TRIED", True)
        mp.setattr(jax_native, "_LIB", None)
        mp.setattr(jax_module_mod, "Dropout2d", _NoDropout)
        model = JaxDeepLabV3Plus(nclass=19, backbone="xception65",
                                 encoder_norm=JaxNorm(eps=1e-3), decoder_norm=JaxNorm(),
                                 output_stride=16)
        variables = jax_variables(model, np.zeros((1, CROP, CROP, 3), np.float32))
        batches, pad = _device_batches(2)
        schedule = jax_lr(jcfg, ITERS_PER_EPOCH)
        params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
        tx = jax_optimizer(jcfg, params, schedule)
        state = TrainState(step=jnp.asarray(0, jnp.int32), params=params,
                           batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                                              variables["batch_stats"]),
                           opt_state=tx.init(params), rng=jax.random.PRNGKey(0))
        mesh = Mesh(np.asarray(jax.devices()[:1]), ("data",))
        augment = JaxDeviceAugment(CROP, list(jcfg.DATASET.MEAN), list(jcfg.DATASET.STD), pad)
        step = jax_make_train_step(model, jax_loss("DeepLabV3_Plus", **LOSS_KW), tx, mesh,
                                   donate=False, augment=augment)
        after = []
        for batch in batches:
            state, loss = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
            after.append((float(loss), jax.tree_util.tree_map(np.asarray, state.params),
                          jax.tree_util.tree_map(np.asarray, state.batch_stats)))
        images, masks = _val_batch()
        cm = jax_make_eval_step(model, 19, mesh)(variables["params"], variables["batch_stats"],
                                                 images, masks)
        return dict(variables=variables, after=after, batches=batches, pad=pad,
                    cm=np.asarray(cm))


def _val_batch():
    rng = np.random.RandomState(7)
    images = rng.randint(0, 256, (2, CROP, CROP, 3)).astype(np.uint8)
    masks = rng.randint(-1, 19, (2, CROP, CROP)).astype(np.int32)
    return images, masks


def _close(got, want, what="", tol=TAP_TOL):
    assert got.shape == want.shape, what
    atol = tol * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=tol, atol=atol, err_msg=what)


def _port_step(pcfg, remat="none", dropout=True):
    model = get_segmentation_model("cpu")
    if not dropout:
        for m in model.modules():
            if isinstance(m, Dropout2d):
                m.rate = 0.0
    schedule = get_lr_scheduler(pcfg, ITERS_PER_EPOCH)
    step = make_train_step(model, get_segmentation_loss("DeepLabV3_Plus", **LOSS_KW),
                           get_optimizer(pcfg, model, schedule), schedule, remat=remat,
                           device="cpu", augment=None)
    return model, step


def test_two_flagship_steps_match_jax(reference, pcfg):
    model, step = _port_step(pcfg, dropout=False)
    model.load_state_dict(from_flax_variables(reference["variables"]), strict=True)
    step.augment = DeviceAugment(CROP, list(pcfg.DATASET.MEAN), list(pcfg.DATASET.STD),
                                 reference["pad"])
    assert model.training and step.remat == "none"
    for i, (batch, (want_loss, params, stats)) in enumerate(zip(reference["batches"],
                                                               reference["after"])):
        got = step({k: torch.from_numpy(v) for k, v in batch.items()})
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(float(got), want_loss, rtol=LOSS_RTOL if i == 0 else
                                   UPDATED_LOSS_RTOL, err_msg=f"step {i}")
        want = from_flax_variables({"params": params, "batch_stats": stats})
        state = model.state_dict()
        assert set(want) == set(state)
        for key, value in want.items():
            if not key.endswith("num_batches_tracked"):
                _close(state[key].numpy(), value.numpy(), f"step {i}: {key}",
                       TAP_TOL if i == 0 else UPDATED_TOL)


def _remat_run(pcfg, remat, batch):
    """One step with dropout on from the same initial model and generator
    seed: (loss, grads, state_dict after the update)."""
    model, step = _port_step(pcfg, remat=remat)
    loss = step(*batch)
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return loss, grads, copy.deepcopy(model.state_dict())


@pytest.fixture(scope="module")
def remat_batch():
    rng = np.random.RandomState(11)
    images = rng.randint(0, 256, (BATCH, CROP, CROP, 3)).astype(np.uint8)
    masks = rng.randint(-1, 19, (BATCH, CROP, CROP)).astype(np.int32)
    return images, masks


@pytest.fixture(scope="module")
def remat_none(remat_batch):
    with _flagship(port_cfg) as cfg:
        return _remat_run(cfg, "none", remat_batch)


@pytest.mark.parametrize("remat", ["dots", "full"])
def test_remat_equals_none_with_dropout(pcfg, remat_none, remat_batch, remat):
    loss, grads, state = _remat_run(pcfg, remat, remat_batch)
    want_loss, want_grads, want_state = remat_none
    assert torch.equal(loss, want_loss)
    assert grads.keys() == want_grads.keys()
    for name, g in want_grads.items():
        assert torch.equal(grads[name], g), name
    for key, value in want_state.items():
        assert torch.equal(state[key], value), key
    aspp_dropout = [m for m in get_segmentation_model("cpu").modules()
                    if isinstance(m, Dropout2d)]
    assert aspp_dropout and all(m.rate == 0.5 for m in aspp_dropout)


@pytest.mark.parametrize("guard", ["generator", "statistics"])
def test_remat_guards_are_needed(pcfg, remat_none, remat_batch, monkeypatch, guard):
    """Without the recompute's guards "full" takes another step: the
    recomputed dropout masks differ (wrong gradients, no error), or the BN
    running statistics move twice."""
    if guard == "generator":
        def enter_without_generator(self):
            self.stack = contextlib.ExitStack()
            self.stack.enter_context(steps.running_stats_frozen())
            self.stack.enter_context(self.inner)
            return self

        monkeypatch.setattr(steps._Recompute, "__enter__", enter_without_generator)
    else:
        monkeypatch.setattr(steps, "running_stats_frozen", contextlib.nullcontext)
    loss, grads, state = _remat_run(pcfg, "full", remat_batch)
    want_loss, want_grads, want_state = remat_none
    assert torch.equal(loss, want_loss)  # the forward itself is the same
    if guard == "generator":
        assert any(not torch.equal(grads[n], g) for n, g in want_grads.items())
    else:
        stats = [k for k in want_state if k.endswith("running_mean")]
        assert all(not torch.equal(state[k], want_state[k]) for k in stats)


def test_dots_policy_saves_the_products(monkeypatch):
    """TPU.REMAT "dots": in the forward, the outputs of convolution, mm,
    addmm and bmm are kept and the rest (BN, ReLU, the elementwise ops)
    is left to the backward, which runs the forward again."""
    decisions = []
    policy = steps._dots_policy

    def recording(ctx, op, *args, **kwargs):
        decision = policy(ctx, op, *args, **kwargs)
        decisions.append((ctx.is_recompute, op, decision))
        return decision

    monkeypatch.setattr(steps, "_dots_policy", recording)
    model = torch.nn.Sequential(torch.nn.Conv2d(3, 8, 3, padding=1), torch.nn.BatchNorm2d(8),
                                torch.nn.ReLU(), torch.nn.Flatten(), torch.nn.Linear(8 * 36, 5))
    model.train()
    step = make_train_step(model, lambda out, t: (out.float() - t).square().mean(),
                           torch.optim.SGD(model.parameters(), lr=0.1), lambda s: 0.1,
                           remat="dots", device="cpu")
    x = torch.randn(2, 6, 6, 3)
    calls = []
    model[1].register_forward_hook(lambda *_: calls.append(1))
    step.model = torch.nn.Sequential(_Nchw(), model)
    step.forward = lambda inp, f=steps.TrainStep.forward: f(step, inp)
    step.params = dict(step.model.named_parameters())
    step(x.numpy(), torch.zeros(2, 5).numpy())
    forward = {op: d for rec, op, d in decisions if not rec}
    aten = torch.ops.aten
    assert forward[aten.convolution.default] == CheckpointPolicy.MUST_SAVE
    assert forward[aten.addmm.default] == CheckpointPolicy.MUST_SAVE
    recomputed = [op for op, d in forward.items() if d == CheckpointPolicy.PREFER_RECOMPUTE]
    assert aten.relu.default in recomputed
    assert any("batch_norm" in str(op) for op in recomputed)
    assert len(calls) == 2  # the backward recomputed the forward


class _Nchw(torch.nn.Module):
    def forward(self, x):
        return x.permute(0, 3, 1, 2)


def test_eval_step_matches_jax(reference, pcfg):
    """The confusion matrix of ``make_eval_step`` (the fused entry's plain
    version on the CPU) against the JAX eval step's (its unfused entry) on
    two images with ignore pixels: a near-tie argmax may differ, so at
    most 0.1 % of the pixels may move between cells."""
    model = get_segmentation_model("cpu")
    model.load_state_dict(from_flax_variables(reference["variables"]), strict=True)
    model.train()
    images, masks = _val_batch()
    cm = make_eval_step(model, 19, "float32", "cpu")(images, masks)
    assert model.training  # the eval step restores the mode
    assert cm.dtype == torch.int64 and cm.shape == (19, 19)
    want = reference["cm"]
    assert cm.sum().item() == want.sum() == (masks >= 0).sum()
    assert np.abs(cm.numpy() - want).sum() <= 2 * 0.001 * masks.size
    bf16 = make_eval_step(model, 19, "bfloat16", "cpu")(images, masks)
    assert bf16.sum().item() == want.sum()
    assert all(p.dtype == torch.float32 for p in model.parameters())  # masters stay f32
