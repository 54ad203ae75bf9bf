"""Normalization factory (counterpart of
``segmentron_tpu/modules/batch_norm.py``).

``cfg.MODEL.BN_TYPE`` BN, SyncBN and FrozenBN are each a ``BatchNorm2d``
here (one card: SyncBN is BN, as the JAX package downgrades it on one
replica); FrozenBN is built with ``frozen=True`` and normalizes with the
running statistics in training too, never updating them. GN is a
``GroupNorm``. The encoder and the decoder carry separate epsilons
(``BN_EPS_FOR_ENCODER`` / ``BN_EPS_FOR_DECODER``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["BatchNorm2d", "NormConfig", "norm_from_cfg"]

_TORCH_BN_DEFAULT_MOMENTUM = 0.1
_TORCH_BN_DEFAULT_EPS = 1e-5


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` with flax's semantics, for an input of any float
    dtype with f32 statistics and affine; the output has the input's
    dtype (the JAX package casts weights to the compute dtype and keeps
    the statistics in f32).

    In training it normalizes with the batch statistics, computed in f32,
    and updates the running ones as ``flax.linen.BatchNorm`` does: with
    the biased batch variance (torch's own update takes the unbiased
    one), ``running = (1 - m) running + m batch`` at ``m = momentum``.
    ``frozen`` (FrozenBN) normalizes with the running statistics in
    training too and never updates them. The buffers stay f32."""

    def __init__(self, num_features: int, eps: float = _TORCH_BN_DEFAULT_EPS,
                 momentum: float = _TORCH_BN_DEFAULT_MOMENTUM, frozen: bool = False):
        super().__init__(num_features, eps=eps, momentum=momentum)
        self.frozen = frozen

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        weight, bias = self.weight.float(), self.bias.float()
        if not self.training or self.frozen:
            return F.batch_norm(x, self.running_mean, self.running_var, weight, bias, False,
                                0.0, self.eps)
        out, mean, invstd = torch.native_batch_norm(x, weight, bias, None, None, True, 0.0,
                                                    self.eps)
        with torch.no_grad():
            # the biased variance, back from the kernel's 1 / sqrt(var + eps)
            var = (invstd.float().pow(-2) - self.eps).clamp_(min=0.0)
            self.running_mean.lerp_(mean.float(), self.momentum)
            self.running_var.lerp_(var, self.momentum)
        return out


@dataclasses.dataclass(frozen=True)
class NormConfig:
    """Static norm configuration threaded through model constructors."""

    bn_type: str = "BN"  # BN | SyncBN | FrozenBN | GN
    eps: float = _TORCH_BN_DEFAULT_EPS
    torch_momentum: float = _TORCH_BN_DEFAULT_MOMENTUM
    group_count: int = 32

    def make(self, channels: int) -> nn.Module:
        if self.bn_type in ("BN", "SyncBN", "FrozenBN"):
            return BatchNorm2d(channels, eps=self.eps, momentum=self.torch_momentum,
                               frozen=self.bn_type == "FrozenBN")
        if self.bn_type == "GN":
            return nn.GroupNorm(self.group_count, channels, eps=self.eps)
        raise ValueError(f"Unknown BN_TYPE: {self.bn_type}")


def norm_from_cfg(cfg, encoder: bool = True) -> NormConfig:
    """NormConfig from the config tree: BN_TYPE, BN_MOMENTUM (torch
    convention) and the encoder/decoder epsilons."""
    eps = cfg.MODEL.BN_EPS_FOR_ENCODER if encoder else cfg.MODEL.BN_EPS_FOR_DECODER
    momentum: Optional[float] = cfg.MODEL.BN_MOMENTUM
    return NormConfig(
        bn_type=cfg.MODEL.BN_TYPE,
        eps=float(eps) if eps is not None else _TORCH_BN_DEFAULT_EPS,
        torch_momentum=(
            float(momentum) if momentum is not None else _TORCH_BN_DEFAULT_MOMENTUM
        ),
        group_count=int(cfg.MODEL.DEFAULT_GROUP_NUMBER),
    )
