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
``stem1..3``).

``cfg.TPU.INT8_RESNET`` (``int8_k``: the range factor ``cfg.TPU.INT8_K``,
None for off) gives the blocks the JAX package's static-int8 interiors
in eval: conv1 in the compute dtype with bn1 folded, ReLU and a quantize
at bn1's range ``|c| + k|a|``; conv2 (and a Bottleneck's conv3) s8 x s8
through ``ops/quant.py::qconv`` with the next BN folded into its f32
epilogue; the downsample in the compute dtype with its BN folded in f32;
``relu(y + identity)`` in f32, cast to the input's dtype. The gates are
the JAX package's: eval only, BN/SyncBN/FrozenBN only, and not where the
int8 conv runs at dilation 8 or more (a Bottleneck's ``dilation``, a
BasicBlock's ``previous_dilation``). Folded and quantized weights are
kept until a weight is replaced or changed in place.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...modules import ConvBNReLU, NormConfig, conv2d
from ...ops.quant import (
    bn_amax, bn_folded_affine, fold_and_quantize_weights, matmul_weights, qconv,
    quantize_static,
)
from ...ops.sepconv import WeightCache
from .build import BACKBONE_REGISTRY

__all__ = ["BasicBlock", "Bottleneck", "ResNet", "int8_resnet_k", "set_int8_resnet"]

_BN_TYPES = ("BN", "SyncBN", "FrozenBN")


def int8_resnet_k(cfg) -> Optional[float]:
    """The blocks' ``int8_k`` under ``cfg``: ``TPU.INT8_K`` with
    ``TPU.INT8_RESNET`` on and ``TPU.INT8_CALIBRATE`` off, else None."""
    t = cfg.TPU
    return float(t.INT8_K) if bool(t.INT8_RESNET) and not bool(t.INT8_CALIBRATE) else None


def set_int8_resnet(model: nn.Module, int8_k: Optional[float]) -> None:
    """Switch the int8 interiors of every ResNet block in ``model``."""
    for m in model.modules():
        if isinstance(m, _Int8Block):
            m.int8_k = int8_k


def _folded(bn):
    return bn_folded_affine(bn.weight, bn.bias, bn.running_mean, bn.running_var, bn.eps)


def _hwio(conv):
    return conv.weight.permute(2, 3, 1, 0)


class _Int8Block(nn.Module):
    """What the int8 interiors of ``BasicBlock`` and ``Bottleneck`` share:
    the gate, the folded weights and the int8 forward. A subclass lists
    its int8 convs and their BNs in ``_int8_convs``."""

    def __init__(self, int8_k: Optional[float], norm: NormConfig, int8_dilation: int):
        super().__init__()
        self.int8_k = int8_k
        self.norm_type = norm.bn_type
        self.int8_dilation = int8_dilation  # the dilation of the int8 conv the gate reads
        self._cache = WeightCache()

    def _int8_interior(self) -> bool:
        return (not self.training and self.int8_k is not None and self.int8_dilation < 8
                and self.norm_type in _BN_TYPES)

    def _int8_weights(self, x):
        """(a1, c1, bn1's amax, [(quantized pair, folded BN, output amax
        or None) per int8 conv], the downsample's folded BN or None)."""
        tensors = [*self.parameters(), *self.buffers()]
        return self._cache.get((x.dtype, x.device, self.int8_k), tensors, self._fold_int8)

    def _fold_int8(self):
        k = self.int8_k
        a1, c1 = _folded(self.bn1)
        amax = amax1 = bn_amax(a1, c1, k=k)
        convs = []
        pairs = self._int8_convs()
        for i, (conv, bn) in enumerate(pairs):
            w_q, s_w = fold_and_quantize_weights(_hwio(conv), amax / 127.0)
            a, c = _folded(bn)
            amax = bn_amax(a, c, k=k) if i + 1 < len(pairs) else None
            convs.append(((matmul_weights(w_q), s_w), (a, c), amax))
        down = _folded(self.downsample_bn) if self.use_downsample else None
        return a1, c1, amax1, convs, down

    def _int8_forward(self, x):
        """conv1 in the input's dtype, bn1 folded, ReLU, quantize; the int8
        convs; the residual add."""
        a1, c1, amax1, convs, down = self._int8_weights(x)
        y = torch.relu(self.conv1(x).permute(0, 2, 3, 1).float() * a1 + c1)
        q = quantize_static(y, amax1)
        for (conv, _), (quantized, affine, out_amax) in zip(self._int8_convs(), convs):
            q = qconv(q, _hwio(conv), conv.stride, conv.padding, conv.dilation,
                      bn_affine=affine, relu=out_amax is not None, out_amax=out_amax,
                      quantized=quantized)
        if down is not None:
            a_d, c_d = down
            identity = self.downsample_conv(x).permute(0, 2, 3, 1).float() * a_d + c_d
        else:
            identity = x.permute(0, 2, 3, 1).float()
        out = torch.relu(q + identity).to(x.dtype)
        return out.permute(0, 3, 1, 2)  # NHWC-contiguous = channels_last NCHW


class BasicBlock(_Int8Block):
    """3x3 (stride, dilation) -> 3x3 (previous dilation), residual; with
    ``int8_k``, conv2 runs s8 x s8 in eval."""

    expansion = 1

    def __init__(self, in_channels: int, features: int, stride: int = 1, dilation: int = 1,
                 previous_dilation: int = 1, use_downsample: bool = False,
                 norm: NormConfig = NormConfig(), int8_k: Optional[float] = None):
        super().__init__(int8_k, norm, previous_dilation)
        self.conv1 = conv2d(in_channels, features, 3, stride, None, dilation)
        self.bn1 = norm.make(features)
        self.conv2 = conv2d(features, features, 3, 1, None, previous_dilation)
        self.bn2 = norm.make(features)
        if use_downsample:
            self.downsample_conv = conv2d(in_channels, features, 1, stride, 0)
            self.downsample_bn = norm.make(features)
        self.use_downsample = use_downsample

    def _int8_convs(self):
        return ((self.conv2, self.bn2),)

    def forward(self, x):
        if self._int8_interior():
            return self._int8_forward(x)
        y = self.bn1(self.conv1(x)).relu()
        y = self.bn2(self.conv2(y))
        identity = self.downsample_bn(self.downsample_conv(x)) if self.use_downsample else x
        return (y + identity).relu()


class Bottleneck(_Int8Block):
    """1x1 -> 3x3 (stride, dilation) -> 1x1 (x4 channels), residual; with
    ``int8_k``, conv2 and conv3 run s8 x s8 in eval."""

    expansion = 4

    def __init__(self, in_channels: int, features: int, stride: int = 1, dilation: int = 1,
                 previous_dilation: int = 1, use_downsample: bool = False,
                 norm: NormConfig = NormConfig(), int8_k: Optional[float] = None):
        super().__init__(int8_k, norm, dilation)
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

    def _int8_convs(self):
        return ((self.conv2, self.bn2), (self.conv3, self.bn3))

    def forward(self, x):
        if self._int8_interior():
            return self._int8_forward(x)
        y = self.bn1(self.conv1(x)).relu()
        y = self.bn2(self.conv2(y)).relu()
        y = self.bn3(self.conv3(y))
        identity = self.downsample_bn(self.downsample_conv(x)) if self.use_downsample else x
        return (y + identity).relu()


class ResNet(nn.Module):
    def __init__(self, block=Bottleneck, layers: Sequence[int] = (3, 4, 6, 3),
                 output_stride: int = 16, deep_stem: bool = False, stem_width: int = 64,
                 multi_grid: bool = False, multi_dilation: Optional[Sequence[int]] = None,
                 norm: NormConfig = NormConfig(), int8_k: Optional[float] = None):
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
                                     dilations[idx - 1], md if idx == 4 else None, norm, int8_k)
        self.channels = tuple(f * block.expansion for f in (64, 128, 256, 512))

    def _make_layer(self, block, idx, in_ch, features, stride, dilation, multi_dilation, norm,
                    int8_k):
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
                int8_k=int8_k,
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
            int8_k=int8_resnet_k(cfg),
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
