"""Trainer (counterpart of ``segmentron_tpu/engine/trainer.py::Trainer``).

End to end on one device: datasets -> loaders -> model init ->
loss/optimizer/schedule -> train step (mixed precision, ``TPU.REMAT``,
the train augmentation on the device) -> the epoch loop with logging
(loss, lr, images a second, ETA), snapshots, validation with the
confusion matrix on the device, best-mIoU tracking and resume. One card
is one replica, so SyncBN is plain BN (``modules/batch_norm.py``) and
the batch is not split.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..config import cfg
from ..data import DataLoader, get_segmentation_dataset
from ..models import get_segmentation_model
from ..solver import get_lr_scheduler, get_optimizer, get_segmentation_loss
from ..utils import SegmentationMetric, resolve_device
from ..utils.checkpoint import CheckpointManager
from ..utils.flops import show_flops_params
from ..utils.logger import get_logger
from .steps import _as_dtype, make_eval_step, make_train_step

__all__ = ["Trainer"]


class Trainer:
    """``Trainer(args=None, seed=None, device=None).train()``: ``args`` as
    ``utils/options.py::parse_args`` gives them, ``seed`` (default
    ``cfg.SEED``) seeds the model's init and the dropout generator,
    ``device`` defaults to CUDA (raises when there is none; pass
    ``device="cpu"`` for the CPU)."""

    def __init__(self, args=None, seed=None, device=None):
        self.args = args
        self.logger = get_logger()
        self.device = resolve_device(device)
        self.seed = int(cfg.SEED if seed is None else seed)
        # one device: the batch's data axis has size 1, so any batch divides it
        if int(np.prod(list(cfg.TPU.MESH_SHAPE) or [1])) != 1:
            raise NotImplementedError(f"TPU.MESH_SHAPE={list(cfg.TPU.MESH_SHAPE)}: a mesh of "
                                      "several devices is not ported to PyTorch yet")

        # ------------------------------------------------------- data
        data_kwargs = dict(base_size=cfg.TRAIN.BASE_SIZE, crop_size=cfg.TRAIN.CROP_SIZE)
        self.train_dataset = get_segmentation_dataset(cfg.DATASET.NAME, split="train",
                                                      mode="train", **data_kwargs)
        self.val_dataset = get_segmentation_dataset(cfg.DATASET.NAME, split="val", mode="val",
                                                    **data_kwargs)
        self.device_augment = None
        if bool(cfg.TPU.DEVICE_AUGMENT):
            from ..data.device_input import DeviceInput, resolve_canvas
            from ..ops.preprocess import DeviceAugment

            canvas = resolve_canvas(self.train_dataset)
            if canvas is not None:
                self.train_dataset.device_input = DeviceInput(self.train_dataset, canvas)
                self.device_augment = DeviceAugment(
                    crop=cfg.TRAIN.CROP_SIZE, mean=list(cfg.DATASET.MEAN),
                    std=list(cfg.DATASET.STD),
                    pad_label=self.train_dataset.device_input.pad_label)
                self.logger.info("Device input pipeline: train augment on device "
                                 "(canvas %dx%d)", canvas[0], canvas[1])
            else:
                self.logger.info("TPU.DEVICE_AUGMENT set but dataset %s has no static canvas "
                                 "(set DATASET.DEVICE_CANVAS): host augment", cfg.DATASET.NAME)
        self.train_loader = DataLoader(
            self.train_dataset, batch_size=cfg.TRAIN.BATCH_SIZE, shuffle=True, seed=cfg.SEED,
            num_workers=cfg.DATASET.WORKERS, prefetch=cfg.TPU.PREFETCH, device=self.device)
        # the ragged tail is kept: validate() pads it with ignore pixels,
        # so every val image counts
        self.val_loader = DataLoader(
            self.val_dataset, batch_size=int(cfg.TEST.BATCH_SIZE), shuffle=False,
            drop_last=False, num_workers=cfg.DATASET.WORKERS, prefetch=cfg.TPU.PREFETCH,
            device=self.device)
        self.iters_per_epoch = len(self.train_loader)
        self.max_iters = cfg.TRAIN.EPOCHS * self.iters_per_epoch

        # ------------------------------------------------------ model
        self.model = get_segmentation_model("cpu", torch.Generator().manual_seed(self.seed))
        self.nclass = self.train_dataset.num_class
        if cfg.TRAIN.BACKBONE_PRETRAINED and cfg.MODEL.BACKBONE:
            from ..utils.download import resolve_pretrained

            # raises for an explicit path that is missing, and for weights
            # that are found (loading them is not ported yet)
            resolve_pretrained(cfg.MODEL.BACKBONE.lower(), cfg.TRAIN.BACKBONE_PRETRAINED_PATH)
            self.logger.info("No pretrained weights found for backbone %s; training from "
                             "scratch", cfg.MODEL.BACKBONE)
        show_flops_params(self.model, (1, cfg.TRAIN.CROP_SIZE, cfg.TRAIN.CROP_SIZE, 3),
                          self.logger)
        self.model.to(self.device, memory_format=torch.channels_last)

        # ----------------------------------------------------- solver
        self.criterion = get_segmentation_loss(
            cfg.MODEL.MODEL_NAME, use_ohem=cfg.SOLVER.OHEM, aux=cfg.SOLVER.AUX,
            aux_weight=cfg.SOLVER.AUX_WEIGHT, loss_name=cfg.SOLVER.LOSS_NAME,
            ohem_thresh=cfg.SOLVER.OHEM_THRESH, ohem_min_kept=cfg.SOLVER.OHEM_MIN_KEPT,
            multi_loss_weight=list(cfg.MODEL.MULTI_LOSS_WEIGHT),
            se_weight=cfg.MODEL.ENCNET.SE_WEIGHT)
        self.lr_schedule = get_lr_scheduler(cfg, self.iters_per_epoch)
        self.optimizer = get_optimizer(cfg, self.model, self.lr_schedule)

        # ------------------------------------------------------ steps
        compute_dtype = _as_dtype(cfg.TPU.COMPUTE_DTYPE)
        if compute_dtype != torch.float32:
            self.logger.info("Mixed precision: %s compute, fp32 params",
                             str(compute_dtype).replace("torch.", ""))
        self.generator = torch.Generator(device=self.device).manual_seed(self.seed)
        self.train_step = make_train_step(
            self.model, self.criterion, self.optimizer, self.lr_schedule,
            compute_dtype=compute_dtype, remat=str(cfg.TPU.REMAT), device=self.device,
            generator=self.generator, augment=self.device_augment)
        self.eval_step = make_eval_step(self.model, self.nclass, compute_dtype, self.device)

        # ------------------------------------------------- checkpoint
        self.ckpt = CheckpointManager(
            os.path.join(cfg.TRAIN.MODEL_SAVE_DIR or "runs/checkpoints", "snapshots"))
        self.best_miou = 0.0
        self.start_epoch = 0
        if cfg.TRAIN.RESUME_MODEL_PATH or (args is not None and getattr(args, "resume", False)):
            self._resume()

    # ------------------------------------------------------------------
    def state_dict(self) -> dict:
        """What a snapshot holds: the step, the model (BN buffers
        included), the optimizer, the dropout generator and the seed."""
        return {"step": self.train_step.updates, "model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "generator": self.generator.get_state(), "seed": self.seed}

    def load_state_dict(self, state: dict) -> None:
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.generator.set_state(state["generator"])
        self.train_step.updates = int(state["step"])
        self.seed = int(state["seed"])

    def _resume(self) -> None:
        # TRAIN.RESUME_MODEL_PATH may name another run's snapshot directory
        src = self.ckpt
        path = str(cfg.TRAIN.RESUME_MODEL_PATH or "")
        if path and os.path.abspath(path) != os.path.abspath(src.directory):
            if not os.path.isdir(path):
                raise FileNotFoundError(f"TRAIN.RESUME_MODEL_PATH={path!r} not found")
            src = CheckpointManager(path)
        # the best mIoU is read only here: a fresh run in a reused
        # directory must not inherit an earlier run's best
        meta = src.best_meta()
        self.best_miou = float(meta["miou"]) if meta else 0.0
        restored = src.restore_latest()
        if restored is not None:
            self.load_state_dict(restored)
            step = self.train_step.updates
            self.start_epoch = step // max(self.iters_per_epoch, 1)
            self.logger.info("Resumed from step %d (epoch %d)", step, self.start_epoch)

    # ------------------------------------------------------------------
    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def train(self) -> float:
        log_iters = max(1, getattr(self.args, "log_iter", 10) if self.args else 10)
        val_epoch = max(1, getattr(self.args, "val_epoch", 1) if self.args else 1)
        skip_val = getattr(self.args, "skip_val", False) if self.args else False
        epochs = cfg.TRAIN.EPOCHS
        if cfg.UTILS.EPOCH_STOP > 0:
            epochs = min(epochs, cfg.UTILS.EPOCH_STOP)
        start = time.time()
        last_log = start
        imgs_since_log = 0
        final_loss = float("nan")
        loss = None
        run_iter0 = self.start_epoch * self.iters_per_epoch  # for the ETA

        # optional torch.profiler window over steps
        # [PROFILE_START, PROFILE_START + PROFILE_STEPS)
        prof_n = int(cfg.UTILS.PROFILE_STEPS)
        prof_lo = int(cfg.UTILS.PROFILE_START)
        profiler = None

        for epoch in range(self.start_epoch, epochs):
            self.train_loader.set_epoch(epoch)
            epoch_t0 = fetch_t0 = time.perf_counter()
            waited = 0.0
            for it, batch in enumerate(self.train_loader):
                waited += time.perf_counter() - fetch_t0
                global_step = epoch * self.iters_per_epoch + it
                if profiler is None and prof_n > 0 and prof_lo <= global_step < prof_lo + prof_n:
                    profiler = self._start_profiler()
                if self.device_augment is not None:
                    loss = self.train_step(batch)
                else:
                    loss = self.train_step(batch["image"], batch["mask"])
                if profiler is not None and global_step >= prof_lo + prof_n - 1:
                    self._stop_profiler(profiler)
                    profiler = None
                imgs_since_log += len(batch["name"])
                step = global_step + 1
                if step % log_iters == 0:
                    loss_v = float(loss)
                    final_loss = loss_v
                    now = time.time()
                    ips = imgs_since_log / max(now - last_log, 1e-6)
                    last_log, imgs_since_log = now, 0
                    lr_v = float(self.lr_schedule(step))
                    # per-iteration time of this run's steps only
                    eta = (self.max_iters - step) * (now - start) / max(step - run_iter0, 1)
                    self.logger.info(
                        "Epoch %d/%d iter %d/%d | loss %.4f | lr %.6f | %.2f img/s "
                        "| ETA %dm", epoch + 1, epochs, it + 1, self.iters_per_epoch,
                        loss_v, lr_v, ips, int(eta / 60))
                fetch_t0 = time.perf_counter()
            if loss is None:
                raise RuntimeError(
                    "train loader yielded no batches: dataset smaller than TRAIN.BATCH_SIZE "
                    f"with drop_last? (len(dataset)={len(self.train_dataset)}, "
                    f"batch={cfg.TRAIN.BATCH_SIZE})")
            final_loss = float(loss)
            self.logger.info("Epoch %d: %d steps in %.3f s, %.3f s of it waiting for the "
                             "loader", epoch + 1, self.iters_per_epoch,
                             time.perf_counter() - epoch_t0, waited)
            # SNAPSHOT_EPOCH <= 0 turns snapshots off
            if cfg.TRAIN.SNAPSHOT_EPOCH > 0 and (epoch + 1) % cfg.TRAIN.SNAPSHOT_EPOCH == 0:
                self.ckpt.save(self.train_step.updates, self.state_dict())
                self.logger.info("Snapshot saved at epoch %d", epoch + 1)
            if not skip_val and (epoch + 1) % val_epoch == 0:
                pix_acc, miou = self.validate()
                self.logger.info("Validation epoch %d: pixAcc %.4f mIoU %.4f", epoch + 1,
                                 pix_acc, miou)
                if miou > self.best_miou:
                    self.best_miou = miou
                    self.ckpt.save_best(self.train_step.updates, self.state_dict(), miou)
                    self.logger.info("New best mIoU %.4f: saved to %s", miou,
                                     self.ckpt.best_directory)
        if profiler is not None:  # the window ran past the last step
            self._stop_profiler(profiler)
        self.ckpt.wait()
        return final_loss

    def _start_profiler(self):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        profiler = profile(activities=activities)
        profiler.start()
        return profiler

    def _stop_profiler(self, profiler) -> None:
        self._sync()
        profiler.stop()
        os.makedirs(cfg.UTILS.PROFILE_DIR, exist_ok=True)
        path = os.path.join(cfg.UTILS.PROFILE_DIR, "trace.json")
        profiler.export_chrome_trace(path)
        self.logger.info("Profiler trace written to %s", path)

    # ------------------------------------------------------------------
    def validate(self):
        """(pixAcc, mIoU) over the val set, its confusion matrix summed on
        the device batch by batch; a ragged last batch is padded to the
        first's size with zero images and ignore (-1) masks."""
        metric = SegmentationMetric(self.nclass)
        full = None
        for batch in self.val_loader:
            images, masks = batch["image"], batch["mask"]
            n = images.shape[0]
            if full is None:
                full = n
            if n != full:
                pad = full - n
                images = torch.cat([images, images.new_zeros((pad,) + images.shape[1:])])
                masks = torch.cat([masks, masks.new_full((pad,) + masks.shape[1:], -1)])
            metric.update_cm(self.eval_step(images, masks))
        return metric.get()
