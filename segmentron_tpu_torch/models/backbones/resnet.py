"""Dilated ResNet backbones (counterpart of
``segmentron_tpu/models/backbones/resnet.py``).

ResNet-V1 with segmentation-style dilation: output stride 8 turns the
strides of layer3 and layer4 into dilations 2 and 4, output stride 16
dilates layer4 only, 32 is the classification layout. The first block of a
dilation-4 stage runs at rate 2 (the reference's "previous dilation"
convention); with ``multi_grid`` the blocks of layer4 take
``multi_dilation[b % len] * max(dilation // 2, 1)``. ``deep_stem`` replaces
the 7x7 stem by three 3x3 ConvBNReLUs (``stem1..3``). Returns the
(c1, c2, c3, c4) taps, NCHW.

Submodules carry the flax scope names (``conv1``, ``bn1``,
``layer{idx}_{b}.conv1 | bn1 | ... | downsample_conv | downsample_bn``,
``stem1..3``). The int8 interiors of the JAX blocks
(``cfg.TPU.INT8_RESNET``) are not ported; the model zoo raises for them.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch.nn as nn
import torch.nn.functional as F

from ...modules import ConvBNReLU, NormConfig, conv2d
from .build import BACKBONE_REGISTRY

__all__ = ["BasicBlock", "Bottleneck", "ResNet"]


class BasicBlock(nn.Module):
    """3x3 (stride, dilation) -> 3x3 (previous dilation), residual."""

    expansion = 1

    def __init__(self, in_channels: int, features: int, stride: int = 1, dilation: int = 1,
                 previous_dilation: int = 1, use_downsample: bool = False,
                 norm: NormConfig = NormConfig()):
        super().__init__()
        self.conv1 = conv2d(in_channels, features, 3, stride, None, dilation)
        self.bn1 = norm.make(features)
        self.conv2 = conv2d(features, features, 3, 1, None, previous_dilation)
        self.bn2 = norm.make(features)
        if use_downsample:
            self.downsample_conv = conv2d(in_channels, features, 1, stride, 0)
            self.downsample_bn = norm.make(features)
        self.use_downsample = use_downsample

    def forward(self, x):
        y = self.bn1(self.conv1(x)).relu()
        y = self.bn2(self.conv2(y))
        identity = self.downsample_bn(self.downsample_conv(x)) if self.use_downsample else x
        return (y + identity).relu()


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride, dilation) -> 1x1 (x4 channels), residual."""

    expansion = 4

    def __init__(self, in_channels: int, features: int, stride: int = 1, dilation: int = 1,
                 previous_dilation: int = 1, use_downsample: bool = False,
                 norm: NormConfig = NormConfig()):
        super().__init__()
        self.conv1 = conv2d(in_channels, features, 1, 1, 0)
        self.bn1 = norm.make(features)
        self.conv2 = conv2d(features, features, 3, stride, None, dilation)
        self.bn2 = norm.make(features)
        self.conv3 = conv2d(features, features * 4, 1, 1, 0)
        self.bn3 = norm.make(features * 4)
        if use_downsample:
            self.downsample_conv = conv2d(in_channels, features * 4, 1, stride, 0)
            self.downsample_bn = norm.make(features * 4)
        self.use_downsample = use_downsample

    def forward(self, x):
        y = self.bn1(self.conv1(x)).relu()
        y = self.bn2(self.conv2(y)).relu()
        y = self.bn3(self.conv3(y))
        identity = self.downsample_bn(self.downsample_conv(x)) if self.use_downsample else x
        return (y + identity).relu()


class ResNet(nn.Module):
    def __init__(self, block=Bottleneck, layers: Sequence[int] = (3, 4, 6, 3),
                 output_stride: int = 16, deep_stem: bool = False, stem_width: int = 64,
                 multi_grid: bool = False, multi_dilation: Optional[Sequence[int]] = None,
                 norm: NormConfig = NormConfig()):
        super().__init__()
        self.deep_stem = deep_stem
        if deep_stem:
            self.stem1 = ConvBNReLU(3, stem_width, 3, 2, norm=norm)
            self.stem2 = ConvBNReLU(stem_width, stem_width, 3, 1, norm=norm)
            self.stem3 = ConvBNReLU(stem_width, stem_width * 2, 3, 1, norm=norm)
            in_ch = stem_width * 2
        else:
            self.conv1 = conv2d(3, 64, 7, 2, 3)
            self.bn1 = norm.make(64)
            in_ch = 64
        if output_stride == 8:
            strides, dilations = (1, 2, 1, 1), (1, 1, 2, 4)
        elif output_stride == 16:
            strides, dilations = (1, 2, 2, 1), (1, 1, 1, 2)
        else:  # 32: classification layout
            strides, dilations = (1, 2, 2, 2), (1, 1, 1, 1)
        self.layers = tuple(layers)
        md = multi_dilation if multi_grid else None
        for idx, features in enumerate((64, 128, 256, 512), start=1):
            in_ch = self._make_layer(block, idx, in_ch, features, strides[idx - 1],
                                     dilations[idx - 1], md if idx == 4 else None, norm)
        self.channels = tuple(f * block.expansion for f in (64, 128, 256, 512))

    def _make_layer(self, block, idx, in_ch, features, stride, dilation, multi_dilation, norm):
        out_ch = features * block.expansion
        for b in range(self.layers[idx - 1]):
            if multi_dilation is not None:
                d = multi_dilation[b % len(multi_dilation)] * max(dilation // 2, 1)
            elif dilation in (1, 2) or b > 0:
                d = dilation
            else:
                d = dilation // 2  # first block of a dilation-4 stage
            setattr(self, f"layer{idx}_{b}", block(
                in_ch, features, stride=stride if b == 0 else 1, dilation=d,
                previous_dilation=dilation,
                use_downsample=b == 0 and (stride != 1 or in_ch != out_ch), norm=norm,
            ))
            in_ch = out_ch
        return in_ch

    def forward(self, x):
        if self.deep_stem:
            x = self.stem3(self.stem2(self.stem1(x)))
        else:
            x = self.bn1(self.conv1(x)).relu()
        x = F.max_pool2d(x, 3, 2, 1)
        taps = []
        for idx, blocks in enumerate(self.layers, start=1):
            for b in range(blocks):
                x = getattr(self, f"layer{idx}_{b}")(x)
            taps.append(x)
        return tuple(taps)


def _register(name: str, block, layers, **kw):
    @BACKBONE_REGISTRY.register(name=name)
    def _ctor(norm: NormConfig, _block=block, _layers=layers, _kw=dict(kw)):
        from ...config import cfg

        return ResNet(
            block=_block,
            layers=_layers,
            output_stride=int(cfg.MODEL.OUTPUT_STRIDE),
            multi_grid=bool(cfg.MODEL.DANET.MULTI_GRID),
            multi_dilation=cfg.MODEL.DANET.MULTI_DILATION,
            norm=norm,
            **_kw,
        )


_register("resnet18", BasicBlock, (2, 2, 2, 2))
_register("resnet34", BasicBlock, (3, 4, 6, 3))
_register("resnet50", Bottleneck, (3, 4, 6, 3))
_register("resnet101", Bottleneck, (3, 4, 23, 3))
_register("resnet152", Bottleneck, (3, 8, 36, 3))
_register("resnet50c", Bottleneck, (3, 4, 6, 3), deep_stem=True)
_register("resnet101c", Bottleneck, (3, 4, 23, 3), deep_stem=True)
_register("resnet152c", Bottleneck, (3, 8, 36, 3), deep_stem=True)
