"""Evaluator (counterpart of ``segmentron_tpu/engine/evaluator.py``).

Evaluation on one device with multi-scale and flip TTA and
sliding-window inference for images larger than ``TEST.CROP_SIZE``
(``engine/tta.py::multi_scale_predict``), scoring the argmax of the
summed probabilities into the confusion matrix. The weights come from
``TEST.TEST_MODEL_PATH`` (the latest snapshot, or the best one with
``TEST.USE_BEST`` or ``--best``) unless a model is handed in. Shape
buckets (``TEST.BUCKET_QUANT``), several devices (``TEST.DISTRIBUTED``),
spatial sharding (``TEST.SPATIAL_SHARD``) and int8 calibration
(``TPU.INT8_CALIBRATION_BATCHES``) are not ported yet and raise
``NotImplementedError``.
"""

from __future__ import annotations

import logging
import time

import torch

from ..config import cfg
from ..data import DataLoader, get_segmentation_dataset
from ..models import get_segmentation_model
from ..models.model_zoo import check_int8_supported
from ..utils import SegmentationMetric, resolve_device
from ..utils.checkpoint import CheckpointManager
from .steps import make_predict_fn
from .tta import multi_scale_predict

__all__ = ["Evaluator"]


def _check_supported() -> None:
    check_int8_supported()
    unsupported = {
        "TEST.BUCKET_QUANT": int(cfg.TEST.BUCKET_QUANT) > 0,
        "TEST.SPATIAL_SHARD": bool(cfg.TEST.SPATIAL_SHARD),
        "TEST.DISTRIBUTED": bool(cfg.TEST.DISTRIBUTED) and torch.cuda.device_count() > 1,
    }
    for key, on in unsupported.items():
        if on:
            raise NotImplementedError(f"cfg.{key} is not ported to PyTorch yet")


class Evaluator:
    """``Evaluator(model=None, dataset=None, device=None, args=None).eval()``.

    ``model`` defaults to ``get_segmentation_model()`` with the weights of
    ``TEST.TEST_MODEL_PATH`` (random init, with a warning, where it is
    empty); ``dataset`` to the cfg's val set; ``device`` to CUDA (raises
    when there is none; pass ``device="cpu"`` for the CPU); ``args`` the
    parsed command line (``--best``)."""

    def __init__(self, model=None, dataset=None, device=None, *, args=None):
        _check_supported()
        self.args = args
        self.logger = logging.getLogger(__name__)
        self.device = resolve_device(device)
        self.dataset = dataset if dataset is not None else get_segmentation_dataset(
            cfg.DATASET.NAME, split="val", mode=cfg.DATASET.MODE,
            crop_size=cfg.TEST.CROP_SIZE or cfg.TRAIN.CROP_SIZE,
        )
        self.loader = DataLoader(
            self.dataset,
            batch_size=1 if cfg.DATASET.MODE == "testval" else cfg.TEST.BATCH_SIZE,
            shuffle=False, num_workers=cfg.DATASET.WORKERS, prefetch=cfg.TPU.PREFETCH,
            device=self.device,
        )
        self.nclass = self.dataset.num_class
        if model is None:
            model = get_segmentation_model(self.device)
            self._load_weights(model)
        self.model = model
        self.predict_fn = make_predict_fn(self.model, cfg.TPU.COMPUTE_DTYPE, self.device)
        self.metric = SegmentationMetric(self.nclass)

    def _load_weights(self, model) -> None:
        path = cfg.TEST.TEST_MODEL_PATH
        if not path:
            self.logger.warning(
                "TEST.TEST_MODEL_PATH empty - evaluating randomly-initialised model")
            return
        use_best = bool(cfg.TEST.USE_BEST) or bool(getattr(self.args, "best", False))
        ckpt = CheckpointManager(path)
        if use_best:
            restored = ckpt.restore_best()
            if restored is None:
                raise FileNotFoundError(
                    f"No best checkpoint under {ckpt.best_directory} "
                    "(train with validation enabled to produce one)")
            meta = ckpt.best_meta()
            if meta:
                self.logger.info("Restoring BEST checkpoint: step %d, mIoU %.4f",
                                 meta["step"], meta["miou"])
        else:
            restored = ckpt.restore_latest()
        if restored is None:
            raise FileNotFoundError(f"No checkpoint found under {path}")
        if "model" not in restored:
            raise KeyError(f"Checkpoint has no 'model': {list(restored)}")
        model.load_state_dict(restored["model"])

    def eval(self):
        """Returns (pixAcc, mIoU, per-class IoU)."""
        self.metric.reset()
        scales = list(cfg.TEST.SCALES)
        flip = bool(cfg.TEST.FLIP)
        crop = cfg.TEST.CROP_SIZE
        t0 = time.perf_counter()
        n_img = 0
        with torch.inference_mode():
            for batch in self.loader:
                probs = multi_scale_predict(
                    self.predict_fn, batch["image"], self.nclass, scales=scales, flip=flip,
                    crop_size=int(crop) if crop else None,
                )
                self.metric.update(probs.argmax(dim=-1), batch["mask"])
                n_img += batch["image"].shape[0]
        dt = time.perf_counter() - t0
        pix_acc, miou, category_iou = self.metric.get(return_category_iou=True)
        self.logger.info(
            "Eval: %d images in %.1fs (%.2f img/s) | pixAcc %.4f | mIoU %.4f",
            n_img, dt, n_img / max(dt, 1e-6), pix_acc, miou,
        )
        classes = getattr(self.dataset, "CLASSES", None)
        for i, iou in enumerate(category_iou):
            cname = classes[i] if classes and i < len(classes) else str(i)
            self.logger.info("  class %-20s IoU %.4f", cname, iou)
        return pix_acc, miou, category_iou
