"""Input normalisation on the device (counterpart of
``segmentron_tpu/ops/preprocess.py::normalize_u8``/``maybe_normalize``)."""

from __future__ import annotations

from typing import Sequence

import torch

__all__ = ["normalize_u8", "maybe_normalize"]


def normalize_u8(
    images: torch.Tensor, mean: Sequence[float], std: Sequence[float]
) -> torch.Tensor:
    """uint8 RGB (..., 3) -> f32 ``(x/255 - mean)/std``, in that order."""
    mean = torch.tensor(mean, dtype=torch.float32, device=images.device)
    std = torch.tensor(std, dtype=torch.float32, device=images.device)
    return (images.float() / 255.0 - mean) / std


def maybe_normalize(images: torch.Tensor, mean, std) -> torch.Tensor:
    """Normalize iff ``images`` are raw uint8; float inputs (normalized
    on the host) pass through untouched."""
    if images.dtype != torch.uint8:
        return images
    return normalize_u8(images, mean, std)
