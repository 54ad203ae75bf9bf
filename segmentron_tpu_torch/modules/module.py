"""Segmentation heads (counterpart of ``segmentron_tpu/modules/module.py``):
``ASPP`` and ``FCNHead``. Dropout is the identity in eval, so the
port, which runs inference only, has none."""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from ..ops import global_avg_pool
from .basic import ConvBNReLU, SeparableConv2d, SepconvRoutes, conv2d
from .batch_norm import NormConfig

__all__ = ["ASPP", "FCNHead"]


class FCNHead(nn.Module):
    """3x3 ConvBNReLU -> 1x1 classifier with bias."""

    def __init__(self, in_channels: int, nclass: int, channels: Optional[int] = None,
                 norm: NormConfig = NormConfig()):
        super().__init__()
        inter = channels or in_channels // 4
        self.block = ConvBNReLU(in_channels, inter, 3, norm=norm)
        self.classifier = conv2d(inter, nclass, 1, 1, 0, bias=True)

    def forward(self, x):
        return self.classifier(self.block(x))


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling: a 1x1 branch, three 3x3 atrous
    branches (separable by default, ReLU after), and an image-pooling
    branch broadcast back over the map; concatenated and projected."""

    def __init__(self, in_channels: int, out_channels: int = 256,
                 atrous_rates: Sequence[int] = (6, 12, 18), separable: bool = True,
                 norm: NormConfig = NormConfig(), routes: SepconvRoutes = SepconvRoutes()):
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

    def forward(self, x):
        branches = [self.b0(x)]
        for i in range(self.n_rates):
            y = getattr(self, f"b{i + 1}")(x)
            branches.append(y.relu() if self.separable else y)
        pooled = self.image_pool(global_avg_pool(x))
        branches.append(pooled.expand(-1, -1, x.shape[2], x.shape[3]))
        y = torch.cat(branches, dim=1)
        return self.project(y)
