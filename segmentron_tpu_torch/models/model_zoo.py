"""Model registry and factory (counterpart of
``segmentron_tpu/models/model_zoo.py::get_segmentation_model``)."""

from __future__ import annotations

import logging

import torch

from ..config import cfg
from ..data.dataloader import NUM_CLASS
from ..modules import norm_from_cfg
from ..utils import resolve_device
from ..utils.registry import Registry
from .segbase import init_weights

MODEL_REGISTRY = Registry("MODEL")

__all__ = ["MODEL_REGISTRY", "check_int8_supported", "get_segmentation_model"]


def check_int8_supported() -> None:
    """Raise for the int8 settings that are not ported yet: of
    ``cfg.TPU.INT8_ACTIVATIONS`` only the "pw" mode is (not ``True`` /
    "full"), and neither ``INT8_RESNET`` nor calibration
    (``INT8_CALIBRATE``, ``INT8_CALIBRATION_BATCHES > 0``) is."""
    t = cfg.TPU
    unsupported = {
        f"TPU.INT8_ACTIVATIONS={t.INT8_ACTIVATIONS!r}":
            t.INT8_ACTIVATIONS not in (False, None, "", "pw"),
        "TPU.INT8_RESNET": bool(t.INT8_RESNET),
        "TPU.INT8_CALIBRATE": bool(t.INT8_CALIBRATE),
        "TPU.INT8_CALIBRATION_BATCHES": int(t.INT8_CALIBRATION_BATCHES) > 0,
    }
    for key, on in unsupported.items():
        if on:
            raise NotImplementedError(f"cfg.{key} is not ported to PyTorch yet")


def get_segmentation_model(device=None, generator: torch.Generator = None):
    """Build the model named by ``cfg.MODEL.MODEL_NAME`` in eval mode,
    randomly initialised from ``generator`` (default: seeded with
    ``cfg.SEED``), on ``device`` (default CUDA; raises when there is
    none) with activations in ``channels_last`` memory."""
    check_int8_supported()
    device = resolve_device(device)
    name = cfg.MODEL.MODEL_NAME
    nclass = NUM_CLASS[cfg.DATASET.NAME.lower()]
    model = MODEL_REGISTRY.get(name)(
        nclass=nclass,
        encoder_norm=norm_from_cfg(cfg, encoder=True),
        decoder_norm=norm_from_cfg(cfg, encoder=False),
    )
    if generator is None:
        generator = torch.Generator().manual_seed(int(cfg.SEED))
    init_weights(model, generator)
    logging.getLogger(__name__).info(
        "Built model %s (backbone=%s, nclass=%d)", name, cfg.MODEL.BACKBONE, nclass
    )
    return model.eval().to(device, memory_format=torch.channels_last)
