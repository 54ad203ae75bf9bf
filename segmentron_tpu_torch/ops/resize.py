"""Bilinear resize (counterpart of ``segmentron_tpu/ops/resize.py``).

The JAX package builds the align-corners interpolation as two matrix
products for the TPU's matrix unit; here it is
``F.interpolate(mode="bilinear")``, the function those matrices
reproduce. NCHW, as every tensor inside the port's models.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

__all__ = ["resize_bilinear"]


def resize_bilinear(
    x: torch.Tensor, size: Sequence[int], align_corners: bool = True
) -> torch.Tensor:
    """Resize NCHW ``x`` to spatial ``size=(H, W)``; a no-op when the
    size already matches."""
    size = (int(size[0]), int(size[1]))
    if tuple(x.shape[-2:]) == size:
        return x
    return F.interpolate(x, size=size, mode="bilinear", align_corners=align_corners)
