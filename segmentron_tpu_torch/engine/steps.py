"""Inference step (counterpart of ``segmentron_tpu/engine/steps.py::make_predict_fn``)."""

from __future__ import annotations

from typing import Callable, Union

import numpy as np
import torch
import torch.nn as nn

from ..config import cfg
from ..ops import maybe_normalize
from ..utils import resolve_device

__all__ = ["make_predict_fn"]


def _as_dtype(dtype: Union[str, torch.dtype, None]) -> torch.dtype:
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        return dtype
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[str(dtype)]


@torch.no_grad()
def _cast_params(model: nn.Module, dtype: torch.dtype) -> None:
    """Cast the float parameters to ``dtype`` in place (the statistics
    stay f32, as the JAX package casts ``params`` and not
    ``batch_stats``). Norm affines are rounded to ``dtype`` but kept in
    f32 storage, so each norm reads one parameter dtype."""
    for module in model.modules():
        keep_f32 = isinstance(module, (nn.BatchNorm2d, nn.GroupNorm))
        for p in module.parameters(recurse=False):
            p.data = p.data.to(dtype).float() if keep_f32 else p.data.to(dtype)


def make_predict_fn(model: nn.Module, compute_dtype=None, device=None) -> Callable:
    """``predict(images) -> logits``: NHWC images (uint8, normalized on
    the device with ``cfg.DATASET.MEAN/STD``, or already-normalized
    floats; numpy or tensor) -> the model's main output as f32 NHWC
    logits.

    Moves ``model`` to ``device`` (default CUDA; raises when there is
    none) and, for a compute dtype other than f32, casts its float
    parameters to that dtype in place."""
    device = resolve_device(device)
    dtype = _as_dtype(compute_dtype)
    model.eval().to(device, memory_format=torch.channels_last)
    if dtype != torch.float32:
        _cast_params(model, dtype)
    mean, std = list(cfg.DATASET.MEAN), list(cfg.DATASET.STD)

    @torch.inference_mode()
    def predict(images) -> torch.Tensor:
        if isinstance(images, np.ndarray):
            images = torch.from_numpy(images)
        x = maybe_normalize(images.to(device), mean, std).to(dtype)
        return model(x)[0].float()

    return predict
