"""Segmentation heads (counterpart of ``segmentron_tpu/modules/module.py``):
``ASPP``, ``FCNHead`` and ``Dropout2d``. Dropout is the identity in eval;
``ASPP``, ``FCNHead`` and the DANet and OCNet heads keep theirs where the
JAX modules have one."""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from ..ops import global_avg_pool
from .basic import ConvBNReLU, SeparableConv2d, SepconvRoutes, conv2d
from .batch_norm import NormConfig

__all__ = ["ASPP", "Dropout2d", "FCNHead"]


class Dropout2d(nn.Module):
    """Channel dropout, as the JAX module: in training each (sample,
    channel) of an NCHW map is kept with probability ``1 - rate`` (a mask
    of shape (N, C, 1, 1)) and the kept ones are scaled by
    ``1 / (1 - rate)``; the identity in eval. The mask is drawn from
    ``generator`` (on the input's device), which the train step sets to
    its own seeded ``torch.Generator``; None draws from torch's default
    generator."""

    def __init__(self, rate: float = 0.1):
        super().__init__()
        self.rate = rate
        self.generator: Optional[torch.Generator] = None

    def forward(self, x):
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        mask = torch.rand((x.shape[0], x.shape[1], 1, 1), generator=self.generator,
                          device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class FCNHead(nn.Module):
    """3x3 ConvBNReLU -> dropout -> 1x1 classifier with bias."""

    def __init__(self, in_channels: int, nclass: int, channels: Optional[int] = None,
                 norm: NormConfig = NormConfig()):
        super().__init__()
        inter = channels or in_channels // 4
        self.block = ConvBNReLU(in_channels, inter, 3, norm=norm)
        self.dropout = Dropout2d(0.1)
        self.classifier = conv2d(inter, nclass, 1, 1, 0, bias=True)

    def forward(self, x):
        return self.classifier(self.dropout(self.block(x)))


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling: a 1x1 branch, three 3x3 atrous
    branches (separable by default, ReLU after), and an image-pooling
    branch broadcast back over the map; concatenated, projected, and
    channel-dropped at ``dropout`` in training."""

    def __init__(self, in_channels: int, out_channels: int = 256,
                 atrous_rates: Sequence[int] = (6, 12, 18), separable: bool = True,
                 norm: NormConfig = NormConfig(), routes: SepconvRoutes = SepconvRoutes(),
                 dropout: float = 0.5):
        super().__init__()
        self.separable = separable
        self.b0 = ConvBNReLU(in_channels, out_channels, 1, padding=0, norm=norm)
        for i, rate in enumerate(atrous_rates):
            if separable:
                branch = SeparableConv2d(in_channels, out_channels, 3, dilation=rate,
                                         norm=norm, relu_first=False, routes=routes)
            else:
                branch = ConvBNReLU(in_channels, out_channels, 3, dilation=rate, norm=norm)
            setattr(self, f"b{i + 1}", branch)
        self.n_rates = len(atrous_rates)
        self.image_pool = ConvBNReLU(in_channels, out_channels, 1, padding=0, norm=norm)
        self.project = ConvBNReLU(
            out_channels * (len(atrous_rates) + 2), out_channels, 1, padding=0, norm=norm
        )
        self.dropout = Dropout2d(dropout)

    def forward(self, x):
        branches = [self.b0(x)]
        for i in range(self.n_rates):
            y = getattr(self, f"b{i + 1}")(x)
            branches.append(y.relu() if self.separable else y)
        pooled = self.image_pool(global_avg_pool(x))
        branches.append(pooled.expand(-1, -1, x.shape[2], x.shape[3]))
        y = torch.cat(branches, dim=1)
        return self.dropout(self.project(y))
