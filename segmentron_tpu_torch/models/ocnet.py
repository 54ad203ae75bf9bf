"""OCNet, object context network (counterpart of ``segmentron_tpu/models/ocnet.py``).

Self-attention object context on c4 (reduced to 512 channels), in the
head that ``cfg.MODEL.OCNet.OC_ARCH`` names:

- ``base``: one self-attention block, concatenated with its input and
  projected;
- ``pyramid``: the map zero-padded to a multiple of each level in {1, 2,
  3, 6} and cut into level x level cells, attention within each cell
  (the padded positions attend and are attended: their q and k are the
  ConvBNReLU of 0, not 0), concatenated pyramid-style;
- ``asp``: ASPP whose 1x1 branch is replaced by the base block (ASP-OC).

The attention is ``ops/attention.py::spatial_attention`` with scale
``key_channels**-0.5``, the flash kernel for large HW under
``cfg.TPU.USE_PALLAS``. With ``aux`` an ``FCNHead`` on c3 (``auxlayer``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..modules import ConvBNReLU, Dropout2d, FCNHead, NormConfig, conv2d
from ..ops import resize_bilinear
from ..ops.attention import spatial_attention
from .danet import flatten, unflatten
from .model_zoo import MODEL_REGISTRY
from .segbase import SegBaseModel

__all__ = ["ASPOCModule", "BaseOCModule", "OCNet", "PyramidOCModule", "SelfAttentionBlock"]


class SelfAttentionBlock(nn.Module):
    def __init__(self, in_channels: int, key_channels: int, value_channels: int,
                 out_channels: int, norm: NormConfig = NormConfig(), use_pallas: bool = False):
        super().__init__()
        self.key_channels = key_channels
        self.use_pallas = use_pallas
        self.f_query = ConvBNReLU(in_channels, key_channels, 1, padding=0, norm=norm)
        self.f_key = ConvBNReLU(in_channels, key_channels, 1, padding=0, norm=norm)
        self.f_value = conv2d(in_channels, value_channels, 1, 1, 0, bias=True)
        self.w_out = conv2d(value_channels, out_channels, 1, 1, 0, bias=True)

    def forward(self, x):
        h, w = x.shape[2:]
        ctx = spatial_attention(flatten(self.f_query(x)), flatten(self.f_key(x)),
                                flatten(self.f_value(x)), scale=self.key_channels ** -0.5,
                                use_pallas=self.use_pallas)
        return self.w_out(unflatten(ctx, h, w))


class BaseOCModule(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, norm: NormConfig = NormConfig(),
                 use_pallas: bool = False):
        super().__init__()
        self.attn = SelfAttentionBlock(in_channels, out_channels // 2, out_channels,
                                       out_channels, norm, use_pallas)
        self.proj = ConvBNReLU(out_channels + in_channels, out_channels, 1, padding=0,
                               norm=norm)
        self.dropout = Dropout2d(0.05)

    def forward(self, x):
        return self.dropout(self.proj(torch.cat([self.attn(x), x], dim=1)))


class PyramidOCModule(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 levels: Sequence[int] = (1, 2, 3, 6), norm: NormConfig = NormConfig(),
                 use_pallas: bool = False):
        super().__init__()
        self.levels = tuple(levels)
        self.out_channels = out_channels
        for li in range(len(self.levels)):
            setattr(self, f"attn{li}", SelfAttentionBlock(
                in_channels, out_channels // 2, out_channels, out_channels, norm, use_pallas))
        self.proj = ConvBNReLU(out_channels * len(self.levels) + in_channels,
                               out_channels * 2, 1, padding=0, norm=norm)
        self.dropout = Dropout2d(0.05)

    def forward(self, x):
        n, c, h, w = x.shape
        co = self.out_channels
        outs = []
        for li, level in enumerate(self.levels):
            ph, pw = -(-h // level) * level, -(-w // level) * level
            bh, bw = ph // level, pw // level
            cells = F.pad(x, (0, pw - w, 0, ph - h)).reshape(n, c, level, bh, level, bw)
            cells = cells.permute(0, 2, 4, 1, 3, 5).reshape(n * level * level, c, bh, bw)
            ctx = getattr(self, f"attn{li}")(cells.contiguous(memory_format=torch.channels_last))
            ctx = ctx.reshape(n, level, level, co, bh, bw).permute(0, 3, 1, 4, 2, 5)
            outs.append(ctx.reshape(n, co, ph, pw)[:, :, :h, :w])
        y = torch.cat(outs + [x], dim=1)
        return self.dropout(self.proj(y))


class ASPOCModule(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 atrous_rates: Sequence[int] = (12, 24, 36), norm: NormConfig = NormConfig(),
                 use_pallas: bool = False):
        super().__init__()
        self.oc_conv = ConvBNReLU(in_channels, out_channels, 3, norm=norm)
        self.oc = BaseOCModule(out_channels, out_channels, norm, use_pallas)
        self.b1 = ConvBNReLU(in_channels, out_channels, 1, padding=0, norm=norm)
        for i, rate in enumerate(atrous_rates):
            setattr(self, f"b{i + 2}", ConvBNReLU(in_channels, out_channels, 3,
                                                  dilation=rate, norm=norm))
        self.n_rates = len(atrous_rates)
        self.proj = ConvBNReLU(out_channels * (self.n_rates + 2), out_channels * 2, 1,
                               padding=0, norm=norm)
        self.dropout = Dropout2d(0.1)

    def forward(self, x):
        branches = [self.oc(self.oc_conv(x)), self.b1(x)]
        branches += [getattr(self, f"b{i + 2}")(x) for i in range(self.n_rates)]
        return self.dropout(self.proj(torch.cat(branches, dim=1)))


_HEADS = {"base": (BaseOCModule, 1), "pyramid": (PyramidOCModule, 2), "asp": (ASPOCModule, 2)}


class OCNet(SegBaseModel):
    def __init__(self, nclass: int, backbone: str = "resnet50", aux: bool = False,
                 encoder_norm: NormConfig = NormConfig(),
                 decoder_norm: NormConfig = NormConfig(), oc_arch: str = "base",
                 use_pallas: bool = False):
        super().__init__(nclass, backbone, aux, encoder_norm, decoder_norm)
        if oc_arch not in _HEADS:
            raise ValueError(f"Unknown OC_ARCH: {oc_arch}")
        norm = self.decoder_norm
        head, widen = _HEADS[oc_arch]
        self.reduce = ConvBNReLU(self.backbone.channels[3], 512, 3, norm=norm)
        self.oc = head(512, 512, norm=norm, use_pallas=use_pallas)
        self.classifier = conv2d(512 * widen, nclass, 1, 1, 0, bias=True)
        if aux:
            self.auxlayer = FCNHead(self.backbone.channels[2], nclass, norm=norm)

    def forward(self, x):
        """(N, H, W, 3) -> ((N, H, W, nclass), [aux])."""
        size = x.shape[1:3]
        c1, c2, c3, c4 = self.backbone(x.permute(0, 3, 1, 2))
        outputs = [self.classifier(self.oc(self.reduce(c4)))]
        if self.aux:
            outputs.append(self.auxlayer(c3))
        return tuple(resize_bilinear(o, size, align_corners=True).permute(0, 2, 3, 1)
                     for o in outputs)


@MODEL_REGISTRY.register(name="OCNet")
def _ocnet(nclass, encoder_norm, decoder_norm):
    from ..config import cfg

    return OCNet(
        nclass=nclass,
        backbone=cfg.MODEL.BACKBONE.lower(),
        aux=bool(cfg.SOLVER.AUX),
        encoder_norm=encoder_norm,
        decoder_norm=decoder_norm,
        oc_arch=str(cfg.MODEL.OCNet.OC_ARCH),
        use_pallas=bool(cfg.TPU.USE_PALLAS),
    )
