"""Evaluator (counterpart of ``segmentron_tpu/engine/evaluator.py``).

Whole-image ('testval') evaluation on one device, accumulating the
confusion matrix: ``TEST.SCALES=[1.0]``, no flip, no sliding window.
With one scale and no flip the JAX package's summed softmax has the
argmax of the logits, which is what is scored here. The other test-time
modes (multi-scale, flip, sliding window, shape buckets, several
devices, spatial sharding) and checkpoint loading are not ported yet
and raise ``NotImplementedError``.
"""

from __future__ import annotations

import logging
import time

import torch

from ..config import cfg
from ..data import get_segmentation_dataset
from ..models import get_segmentation_model
from ..utils import SegmentationMetric, resolve_device
from .steps import make_predict_fn

__all__ = ["Evaluator"]


def _check_supported() -> None:
    unsupported = {
        "TEST.SCALES": list(cfg.TEST.SCALES) != [1.0],
        "TEST.FLIP": bool(cfg.TEST.FLIP),
        "TEST.CROP_SIZE": bool(cfg.TEST.CROP_SIZE),
        "TEST.BUCKET_QUANT": int(cfg.TEST.BUCKET_QUANT) > 0,
        "TEST.SPATIAL_SHARD": bool(cfg.TEST.SPATIAL_SHARD),
        "TEST.DISTRIBUTED": bool(cfg.TEST.DISTRIBUTED) and torch.cuda.device_count() > 1,
        "TEST.TEST_MODEL_PATH": bool(cfg.TEST.TEST_MODEL_PATH),
    }
    for key, on in unsupported.items():
        if on:
            raise NotImplementedError(f"cfg.{key} is not ported to PyTorch yet")


class Evaluator:
    """``Evaluator(model=None, dataset=None, device=None).eval()``.

    ``model`` defaults to ``get_segmentation_model()`` (random init),
    ``dataset`` to the cfg's val set, ``device`` to CUDA (raises when
    there is none; pass ``device="cpu"`` for the CPU)."""

    def __init__(self, model=None, dataset=None, device=None):
        _check_supported()
        self.logger = logging.getLogger(__name__)
        self.device = resolve_device(device)
        self.dataset = dataset if dataset is not None else get_segmentation_dataset(
            cfg.DATASET.NAME, split="val", mode=cfg.DATASET.MODE
        )
        self.nclass = self.dataset.num_class
        self.model = model if model is not None else get_segmentation_model(self.device)
        self.predict_fn = make_predict_fn(self.model, cfg.TPU.COMPUTE_DTYPE, self.device)
        self.metric = SegmentationMetric(self.nclass)

    def eval(self):
        """Returns (pixAcc, mIoU, per-class IoU)."""
        self.metric.reset()
        t0 = time.perf_counter()
        for i in range(len(self.dataset)):
            image, mask, _ = self.dataset[i]
            logits = self.predict_fn(image[None])
            target = torch.from_numpy(mask[None]).to(self.device)
            self.metric.update(logits.argmax(dim=-1), target)
        dt = time.perf_counter() - t0
        pix_acc, miou, category_iou = self.metric.get(return_category_iou=True)
        n_img = len(self.dataset)
        self.logger.info(
            "Eval: %d images in %.1fs (%.2f img/s) | pixAcc %.4f | mIoU %.4f",
            n_img, dt, n_img / max(dt, 1e-6), pix_acc, miou,
        )
        return pix_acc, miou, category_iou
