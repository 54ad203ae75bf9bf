"""The port's ``Trainer`` and ``tools/train.py`` on the CPU: against the
JAX package's ``Trainer`` on the synthetic set, then snapshots, resume,
the best model, the entry point and the run's setup.

The JAX side runs its ``Trainer`` as its own tests do, on a one-device
mesh (its ``create_mesh`` patched, as the port has one device), with its
native host library off (both packages on the PIL path), its FLOPs
report off (a log line that lowers the model once more) and dropout off
on both sides (the frameworks cannot draw the same bits). The flagship
YAML with 2 middle blocks, f32, batch 4 of 128x128 crops from 96x128
sources augmented on the device, 8 train and 4 val images, 2 epochs of 2
steps, validation after the second epoch. After construction the port's
model takes the JAX Trainer's initial variables (flax's default init,
through the weight bridge). The first loss is held to rtol 1e-5, the
later ones, on updated weights, to rtol 1e-3, and the validation's
confusion matrix to at most 0.5 % of the labelled pixels moved between
cells. SGD runs at LR 1e-4: this net amplifies the f32 rounding of each
update step by step (tests/test_torch_flagship_train.py), and at 1e-3
the port's own fourth loss at 1, 2 and 4 CPU threads (the same math
summed in other orders) spreads over 3.0459-3.0627 (5.5e-3 relative;
the JAX package's 3.0535 inside), where at 1e-4 it spreads over
3.11150-3.11241 (2.9e-4; the JAX package's 3.11233) and the confusion
matrices differ from the JAX one's in 0.04-0.07 % of the pixels.

The losses alone would miss a wrong LR schedule: one built for 3
iterations an epoch where the loader gives 2 moves the fourth loss by
9.6e-4 relative. So the final state is held too. The port's update of
all parameters, over the 4 steps, lies at a relative L2 distance of
0.039, 0.031 and 0.028 (1, 2 and 4 CPU threads) from the JAX Trainer's,
and its BN running statistics within 2.3e-4, 2.0e-4 and 5.4e-4 of
max|value|; the gates are 0.1 and 1e-3. Planted faults: the schedule
above reads 0.270, 0.267, 0.264 (statistics 1.9e-3 to 2.1e-3), and a
Trainer that skips ``optimizer.step`` reads 1.0.

The port-only tests use a shorter net (1 middle block, batch 2 of 64x64
crops, 4 images) with dropout on.
"""

import contextlib
import json
import logging
import os

import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import segmentron_tpu.data._native as jax_native
import segmentron_tpu.engine.trainer as jax_trainer_mod
import segmentron_tpu.modules.module as jax_module_mod
import segmentron_tpu_torch.engine.trainer as port_trainer_mod
from segmentron_tpu.config import cfg as jax_cfg
from segmentron_tpu.data import dataloader as jax_datasets
from segmentron_tpu_torch.config import cfg as port_cfg
from segmentron_tpu_torch.data import dataloader as port_datasets
from segmentron_tpu_torch.engine import Trainer
from segmentron_tpu_torch.modules import Dropout2d
from segmentron_tpu_torch.tools import train as train_tool
from segmentron_tpu_torch.utils import default_setup
from segmentron_tpu_torch.utils.checkpoint import CheckpointManager
from segmentron_tpu_torch.utils.convert import from_flax_variables

torch.set_num_threads(2)

FLAGSHIP = "configs/cityscapes_deeplabv3_plus_xception65.yaml"
LOSS_RTOL = 1e-5
UPDATED_LOSS_RTOL = 1e-3
CM_MOVED = 0.005
UPDATE_RTOL = 0.1
STATS_RTOL = 1e-3
PARITY_OPTS = ["DATASET.NAME", "synthetic", "MODEL.XCEPTION.MIDDLE_BLOCKS", "2",
               "TRAIN.CROP_SIZE", "128", "TRAIN.BASE_SIZE", "128", "TRAIN.BATCH_SIZE", "4",
               "TRAIN.EPOCHS", "2", "DATASET.DEVICE_CANVAS", "[96, 128]",
               "TRAIN.BACKBONE_PRETRAINED", "False", "TPU.COMPUTE_DTYPE", "float32",
               "TPU.PREFETCH", "1", "DATASET.WORKERS", "2", "SOLVER.LR", "0.0001"]
SMALL_OPTS = ["DATASET.NAME", "synthetic", "MODEL.XCEPTION.MIDDLE_BLOCKS", "1",
              "TRAIN.CROP_SIZE", "64", "TRAIN.BASE_SIZE", "64", "TRAIN.BATCH_SIZE", "2",
              "TRAIN.EPOCHS", "2", "DATASET.DEVICE_CANVAS", "[48, 64]",
              "TRAIN.BACKBONE_PRETRAINED", "False", "TPU.COMPUTE_DTYPE", "float32",
              "TPU.PREFETCH", "1", "DATASET.WORKERS", "2", "TIME_STAMP", "run"]


def _restore(cfg, snapshot):
    cfg.defrost()
    cfg.clear()
    for k, v in type(cfg)(snapshot).items():
        dict.__setitem__(cfg, k, v)


@contextlib.contextmanager
def _cfg(cfg, opts):
    snapshot = cfg.to_dict()
    cfg.update_from_file(FLAGSHIP)
    cfg.update_from_list(opts)
    try:
        yield cfg
    finally:
        _restore(cfg, snapshot)


def _synthetic(module, length, image_size):
    class Synthetic(module.SyntheticSegmentation):
        def __init__(self, **kwargs):
            super().__init__(length=length, image_size=image_size, **kwargs)

    return Synthetic


class _NoDropout(fnn.Module):
    rate: float = 0.0

    @fnn.compact
    def __call__(self, x, train: bool = False):
        return x


class _Args:
    log_iter, val_epoch, skip_val, resume = 1, 2, False, False


def _record_cms(trainer, cms):
    step = trainer.eval_step

    def recording(*args):
        cm = step(*args)
        cms.append(np.asarray(cm.cpu() if isinstance(cm, torch.Tensor) else cm))
        return cm

    trainer.eval_step = recording


@pytest.fixture(scope="module")
def parity(tmp_path_factory):
    """Both Trainers' losses, step by step, and their final validation's
    confusion matrix."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "_TRIED", True)
        mp.setattr(jax_native, "_LIB", None)
        mp.setattr(jax_module_mod, "Dropout2d", _NoDropout)
        mp.setattr(jax_trainer_mod, "create_mesh",
                   lambda *a: Mesh(np.asarray(jax.devices()[:1]), ("data",)))
        mp.setattr(jax_trainer_mod, "show_flops_params", lambda *a: None)
        mp.setitem(jax_datasets.datasets, "synthetic", _synthetic(jax_datasets, 8, (96, 128)))
        mp.setitem(port_datasets.datasets, "synthetic", _synthetic(port_datasets, 8, (96, 128)))
        tmp = tmp_path_factory.mktemp("parity")
        with _cfg(jax_cfg, PARITY_OPTS + ["TRAIN.MODEL_SAVE_DIR", str(tmp / "jax")]):
            jt = jax_trainer_mod.Trainer(_Args())
            variables = jax.tree_util.tree_map(
                np.asarray, {"params": jt.state.params, "batch_stats": jt.state.batch_stats})
            losses, cms, step = [], [], jt.train_step

            def recording(state, *batch):
                state, loss = step(state, *batch)
                losses.append(float(loss))
                return state, loss

            jt.train_step = recording
            _record_cms(jt, cms)
            jt.train()
            out["jax"] = (losses, sum(cms))
            out["init"] = from_flax_variables(variables)
            out["jax_final"] = from_flax_variables(jax.tree_util.tree_map(
                np.asarray, {"params": jt.state.params, "batch_stats": jt.state.batch_stats}))
        real_schedule = port_trainer_mod.get_lr_scheduler
        for name, args in (("port", _Args()), ("schedule fault", _Args())):
            if name == "schedule fault":  # planted: the schedule one iteration an epoch long
                args.skip_val = True
                mp.setattr(port_trainer_mod, "get_lr_scheduler",
                           lambda c, iters: real_schedule(c, iters + 1))
            with _cfg(port_cfg, PARITY_OPTS + ["TRAIN.MODEL_SAVE_DIR", str(tmp / name)]):
                pt = Trainer(args, device="cpu")
                pt.model.load_state_dict(out["init"], strict=True)
                for m in pt.model.modules():
                    if isinstance(m, Dropout2d):
                        m.rate = 0.0
                losses, cms = [], []
                loss_fn = pt.train_step.loss_fn
                pt.train_step.loss_fn = lambda *a: (
                    lambda v: losses.append(float(v.detach())) or v)(loss_fn(*a))
                _record_cms(pt, cms)
                pt.train()
                out[name] = (losses, sum(cms))
                out[f"{name} final"] = {k: v.detach().clone()
                                        for k, v in pt.model.state_dict().items()}
                out["labelled"] = sum(int((pt.val_dataset[i][1] >= 0).sum())
                                      for i in range(len(pt.val_dataset)))
    return out


def _drift(got, want, init):
    """(the L2 distance of ``got``'s update of every parameter from
    ``want``'s, over the L2 norm of ``want``'s; the BN running statistics'
    max|got - want| over their max|want|)."""
    params = [k for k in init if not k.endswith(("running_mean", "running_var",
                                                 "num_batches_tracked"))]
    stats = [k for k in init if k.endswith(("running_mean", "running_var"))]
    du = torch.cat([(got[k] - init[k]).flatten() for k in params])
    dw = torch.cat([(want[k] - init[k]).flatten() for k in params])
    g = torch.cat([got[k].flatten() for k in stats])
    w = torch.cat([want[k].flatten() for k in stats])
    return float((du - dw).norm() / dw.norm()), float((g - w).abs().max() / w.abs().max())


def test_trainer_matches_jax(parity):
    (got, got_cm), (want, want_cm) = parity["port"], parity["jax"]
    assert len(got) == len(want) == 4
    np.testing.assert_allclose(got[0], want[0], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got[1:], want[1:], rtol=UPDATED_LOSS_RTOL)
    assert got_cm.sum() == want_cm.sum() == parity["labelled"]
    assert np.abs(got_cm - want_cm).sum() <= 2 * CM_MOVED * parity["labelled"]
    update, stats = _drift(parity["port final"], parity["jax_final"], parity["init"])
    assert update <= UPDATE_RTOL and stats <= STATS_RTOL, (update, stats)


@pytest.mark.parametrize("fault", ["updates skipped", "schedule fault"])
def test_trainer_parity_catches_a_planted_fault(parity, fault):
    """The final-state gate of ``test_trainer_matches_jax`` fails for a
    Trainer that skips ``optimizer.step`` (it ends at the initial
    parameters) and for one whose LR schedule counts 3 iterations an
    epoch where the loader gives 2."""
    init, want = parity["init"], parity["jax_final"]
    got = init if fault == "updates skipped" else parity[f"{fault} final"]
    update, _ = _drift(got, want, init)
    assert update > UPDATE_RTOL, update


@pytest.fixture()
def small(tmp_path, monkeypatch):
    """The port's cfg for the short net, save and log dirs under
    ``tmp_path`` and 4 synthetic images of 48x64."""
    monkeypatch.setitem(port_datasets.datasets, "synthetic", _synthetic(port_datasets, 4, (48, 64)))
    with _cfg(port_cfg, SMALL_OPTS + ["TRAIN.MODEL_SAVE_DIR", str(tmp_path / "ckpt"),
                                      "TRAIN.LOG_SAVE_DIR", str(tmp_path / "logs")]) as cfg:
        yield cfg


def _losses(trainer):
    losses, loss_fn = [], trainer.train_step.loss_fn
    trainer.train_step.loss_fn = lambda *a: (lambda v: losses.append(v.detach().clone()) or v)(
        loss_fn(*a))
    return losses


def _fake_miou(monkeypatch):
    """Validation scores 0.1, 0.2, ... in turn: a random net's mIoU may be
    0, which is never a best."""
    scores = iter(np.arange(1, 100) / 10)
    monkeypatch.setattr(Trainer, "validate", lambda self: (0.5, float(next(scores))))


def test_resume_is_bitwise(small, monkeypatch):
    """Epoch 2 of a run stopped after epoch 1 and resumed equals epoch 2 of
    the uninterrupted run, bit for bit: losses (dropout on), parameters,
    BN statistics and momentum; the resumed run reads the best mIoU."""
    _fake_miou(monkeypatch)
    whole = Trainer(device="cpu")
    whole_losses = _losses(whole)
    whole.train()
    small.update_from_list(["TRAIN.MODEL_SAVE_DIR", small.TRAIN.MODEL_SAVE_DIR + "_2",
                            "UTILS.EPOCH_STOP", "1"])
    first = Trainer(device="cpu")
    first.train()
    assert first.ckpt.latest_step() == 2 and first.ckpt.best_meta() is not None
    small.update_from_list(["UTILS.EPOCH_STOP", "-1"])
    resumed = Trainer(type("A", (), {"resume": True})(), device="cpu")
    assert resumed.start_epoch == 1 and resumed.train_step.updates == 2
    assert resumed.best_miou == first.best_miou
    resumed_losses = _losses(resumed)
    resumed.train()
    assert len(whole_losses) == 4 and len(resumed_losses) == 2
    for a, b in zip(resumed_losses, whole_losses[2:]):
        assert torch.equal(a, b)
    want = whole.model.state_dict()
    for key, value in resumed.model.state_dict().items():
        assert torch.equal(value, want[key]), key
    moms = [s["momentum_buffer"] for s in whole.optimizer.state.values()]
    assert all(torch.equal(a["momentum_buffer"], b) for a, b in
               zip(resumed.optimizer.state.values(), moms))
    assert resumed.ckpt.all_steps() == [2, 4]


def test_best_model_and_fresh_run_in_a_reused_dir(small, monkeypatch):
    _fake_miou(monkeypatch)
    trainer = Trainer(device="cpu")
    trainer.train()
    meta = trainer.ckpt.best_meta()
    assert meta == {"step": 4, "miou": pytest.approx(0.2)} and trainer.best_miou == meta["miou"]
    assert json.load(open(os.path.join(trainer.ckpt.best_directory, "best_meta.json"))) == meta
    best = torch.load(os.path.join(trainer.ckpt.best_directory, "step_4.pt"), weights_only=True)
    assert best["step"] == meta["step"] and set(best["model"]) == set(
        trainer.model.state_dict())
    assert not [f for f in os.listdir(trainer.ckpt.directory) if f.startswith(".tmp")]
    fresh = Trainer(device="cpu")  # no resume: no best inherited
    assert fresh.best_miou == 0.0 and fresh.start_epoch == 0


def test_resume_model_path_names_another_run(small, tmp_path):
    small.update_from_list(["UTILS.EPOCH_STOP", "1"])
    first = Trainer(device="cpu")
    first.train()
    small.update_from_list(["TRAIN.MODEL_SAVE_DIR", str(tmp_path / "other"),
                            "TRAIN.RESUME_MODEL_PATH", first.ckpt.directory])
    other = Trainer(device="cpu")
    assert other.train_step.updates == 2 and other.start_epoch == 1
    assert other.ckpt.directory != first.ckpt.directory
    for key, value in first.model.state_dict().items():
        assert torch.equal(other.model.state_dict()[key], value), key
    small.update_from_list(["TRAIN.RESUME_MODEL_PATH", str(tmp_path / "missing")])
    with pytest.raises(FileNotFoundError):
        Trainer(device="cpu")


def test_tools_train_main(small, tmp_path):
    """``python -m segmentron_tpu_torch.tools.train`` as a user runs it,
    on the CPU: the run's directories, config.yaml, the log file, a
    snapshot after epoch 1 (UTILS.EPOCH_STOP 1) and a finite loss."""
    argv = ["--config-file", FLAGSHIP, "--log-iter", "1", *SMALL_OPTS, "TRAIN.MODEL_SAVE_DIR",
            str(tmp_path / "ckpt"), "TRAIN.LOG_SAVE_DIR", str(tmp_path / "logs"),
            "UTILS.EPOCH_STOP", "1"]
    _restore(port_cfg, port_cfg.to_dict())
    loss = train_tool.main(argv, device="cpu")
    assert np.isfinite(loss) and port_cfg.PHASE == "train"
    run = "deeplabv3_plus_xception65_synthetic_run"
    save_dir = tmp_path / "ckpt" / run
    assert port_cfg.TRAIN.MODEL_SAVE_DIR == str(save_dir)
    assert (save_dir / "config.yaml").read_text().count("MIDDLE_BLOCKS: 1")
    assert sorted(os.listdir(save_dir / "snapshots")) == ["step_2.pt"]
    log = (tmp_path / "logs" / run / f"{run}.txt").read_text()
    assert "Epoch 1/1 iter 2/2 | loss" in log and "Validation epoch 1" in log
    assert "No pretrained weights" not in log  # BACKBONE_PRETRAINED False


@pytest.mark.parametrize("case", ["missing", "explicit", "cached", "none"])
def test_backbone_pretrained(small, tmp_path, monkeypatch, caplog, case):
    """``TRAIN.BACKBONE_PRETRAINED``: an explicit path that does not exist
    raises FileNotFoundError; weights found (explicit or in the cache)
    raise NotImplementedError (loading them is not ported); nothing found
    trains from scratch with the JAX package's log line."""
    monkeypatch.setenv("SEGMENTRON_CACHE", str(tmp_path / "cache"))
    (tmp_path / "cache").mkdir()
    small.update_from_list(["TRAIN.BACKBONE_PRETRAINED", "True"])
    if case in ("missing", "explicit"):
        path = tmp_path / "xception65.pth"
        if case == "explicit":
            path.write_bytes(b"weights")
        small.update_from_list(["TRAIN.BACKBONE_PRETRAINED_PATH", str(path)])
    if case == "cached":
        (tmp_path / "cache" / "xception65.pth").write_bytes(b"weights")
    if case == "missing":
        with pytest.raises(FileNotFoundError):
            Trainer(device="cpu")
    elif case in ("explicit", "cached"):
        with pytest.raises(NotImplementedError):
            Trainer(device="cpu")
    else:
        logger = logging.getLogger("segmentron_tpu_torch")
        monkeypatch.setattr(logger, "propagate", True)
        with caplog.at_level(logging.INFO, logger="segmentron_tpu_torch"):
            Trainer(device="cpu")
        assert "No pretrained weights found for backbone xception65" in caplog.text
        assert "forward FLOPs" in caplog.text


def test_validate_pads_the_ragged_tail_and_profiles(small, monkeypatch, tmp_path):
    """3 val images in batches of 2: every labelled pixel counts once; the
    profiler window writes a trace; SNAPSHOT_EPOCH 0 saves no snapshot; a
    mesh of two devices raises; the Trainer defaults to the card."""
    monkeypatch.setitem(port_datasets.datasets, "synthetic", _synthetic(port_datasets, 3, (48, 64)))
    small.update_from_list(["TEST.BATCH_SIZE", "2", "UTILS.PROFILE_STEPS", "1",
                            "UTILS.PROFILE_START", "0", "UTILS.PROFILE_DIR",
                            str(tmp_path / "prof"), "UTILS.EPOCH_STOP", "1",
                            "TRAIN.SNAPSHOT_EPOCH", "0"])
    trainer = Trainer(_Args(), device="cpu")
    sizes = []
    step = trainer.eval_step
    trainer.eval_step = lambda images, masks: sizes.append(images.shape[0]) or step(images, masks)
    trainer.train()
    assert os.path.isfile(tmp_path / "prof" / "trace.json")
    assert sizes == []  # --val-epoch 2: no validation after epoch 1
    assert trainer.ckpt.all_steps() == []  # SNAPSHOT_EPOCH <= 0: no snapshots
    cms = []
    _record_cms(trainer, cms)
    trainer.validate()
    labelled = sum(int((trainer.val_dataset[i][1] >= 0).sum()) for i in range(3))
    assert sum(cms).sum() == labelled and sizes == [2, 2]
    small.update_from_list(["TPU.MESH_SHAPE", "[2]"])
    with pytest.raises(NotImplementedError, match="MESH_SHAPE"):
        Trainer(device="cpu")
    small.update_from_list(["TPU.MESH_SHAPE", "[1]"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer()


def test_setup_guards(small, monkeypatch):
    """One process only: a multi-process launch raises, and
    ``JAX_NUM_PROCESSES`` without a coordinator raises as in the JAX
    package; ``UTILS.DEBUG_NANS`` turns on anomaly detection."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(NotImplementedError):
        default_setup.maybe_initialize_distributed()
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "2")
    with pytest.raises(RuntimeError):
        default_setup.maybe_initialize_distributed()
    monkeypatch.delenv("JAX_NUM_PROCESSES")
    assert default_setup.maybe_initialize_distributed() is False
    small.update_from_list(["UTILS.DEBUG_NANS", "True"])
    try:
        assert default_setup.default_setup() == 1024
        assert torch.is_anomaly_enabled()
        assert port_cfg.is_frozen
    finally:
        torch.autograd.set_detect_anomaly(False)


def test_checkpoint_rotation_and_idempotent_save(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "snapshots"), max_to_keep=3)
    for step in range(1, 7):
        mgr.save(step, {"step": step, "w": torch.full((2,), float(step))})
    assert mgr.all_steps() == [4, 5, 6] and mgr.latest_step() == 6
    mgr.save(6, {"step": 6, "w": torch.zeros(2)})  # already saved: kept as it is
    assert mgr.restore_latest()["w"].tolist() == [6.0, 6.0]
    mgr.save_best(2, {"step": 2}, 0.25)
    mgr.save_best(5, {"step": 5}, 0.5)
    assert mgr.best_meta() == {"step": 5, "miou": 0.5}
    assert sorted(os.listdir(mgr.best_directory)) == ["best_meta.json", "step_5.pt"]
    mgr.wait()
    mgr.close()

