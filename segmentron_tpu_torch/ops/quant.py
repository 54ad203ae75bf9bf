"""BN folding (counterpart of ``segmentron_tpu/ops/quant.py::bn_folded_affine``)."""

from __future__ import annotations

import torch

__all__ = ["bn_folded_affine"]


def bn_folded_affine(scale, bias, mean, var, eps: float):
    """Inference BN as ``y = a*x + b``, computed in f32."""
    a = scale.float() * torch.rsqrt(var.float() + eps)
    b = bias.float() - mean.float() * a
    return a, b
