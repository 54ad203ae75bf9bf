"""DeepLabv3+ (counterpart of ``segmentron_tpu/models/deeplabv3_plus.py``).

c4 -> ASPP -> upsample to c1's size -> concat with the 48-channel 1x1
projection of c1 -> two separable 3x3 convs (ReLU after each) -> 1x1
classifier -> upsample to the input size (align corners). Atrous rates
follow the output stride: {12,24,36} at OS8, {6,12,18} at OS16.
"""

from __future__ import annotations

import torch

from ..modules import (
    ASPP, ConvBNReLU, FCNHead, NormConfig, SeparableConv2d, SepconvRoutes, conv2d,
)
from ..ops import resize_bilinear
from .model_zoo import MODEL_REGISTRY
from .segbase import SegBaseModel

__all__ = ["DeepLabV3Plus"]


class DeepLabV3Plus(SegBaseModel):
    def __init__(self, nclass: int, backbone: str = "xception65", aux: bool = False,
                 encoder_norm: NormConfig = NormConfig(),
                 decoder_norm: NormConfig = NormConfig(), use_aspp: bool = True,
                 enable_decoder: bool = True, aspp_sep: bool = True,
                 decoder_sep: bool = True, output_stride: int = 16,
                 routes: SepconvRoutes = SepconvRoutes()):
        super().__init__(nclass, backbone, aux, encoder_norm, decoder_norm)
        norm = self.decoder_norm
        self.enable_decoder = enable_decoder
        self.decoder_sep = decoder_sep
        rates = (12, 24, 36) if output_stride == 8 else (6, 12, 18)
        if use_aspp:
            self.head = ASPP(2048, 256, rates, separable=aspp_sep, norm=norm, routes=routes)
        else:
            self.head = ConvBNReLU(2048, 256, 3, norm=norm)
        if enable_decoder:
            self.c1_proj = ConvBNReLU(128, 48, 1, padding=0, norm=norm)
            for i, cin in enumerate((256 + 48, 256)):
                if decoder_sep:
                    layer = SeparableConv2d(cin, 256, 3, norm=norm, relu_first=False,
                                            routes=routes)
                else:
                    layer = ConvBNReLU(cin, 256, 3, norm=norm)
                setattr(self, f"decoder{i}", layer)
        self.classifier = conv2d(256, nclass, 1, 1, 0, bias=True)
        if aux:
            self.auxlayer = FCNHead(728, nclass, norm=norm)

    def forward(self, x):
        """(N, H, W, 3) -> ((N, H, W, nclass), [aux])."""
        size = x.shape[1:3]
        x = x.permute(0, 3, 1, 2)
        c1, c2, c3, c4 = self.backbone(x)
        y = self.head(c4)
        if self.enable_decoder:
            low = self.c1_proj(c1)
            y = resize_bilinear(y, low.shape[2:], align_corners=True)
            y = torch.cat([y, low], dim=1)
            for i in range(2):
                y = getattr(self, f"decoder{i}")(y)
                if self.decoder_sep:
                    y = y.relu()
        out = self.classifier(y)
        outputs = [resize_bilinear(out, size, align_corners=True)]
        if self.aux:
            outputs.append(resize_bilinear(self.auxlayer(c3), size, align_corners=True))
        return tuple(o.permute(0, 2, 3, 1) for o in outputs)


@MODEL_REGISTRY.register(name="DeepLabV3_Plus")
def _deeplabv3_plus(nclass, encoder_norm, decoder_norm):
    from ..config import cfg

    d = cfg.MODEL.DEEPLABV3_PLUS
    return DeepLabV3Plus(
        nclass=nclass,
        backbone=cfg.MODEL.BACKBONE.lower(),
        aux=bool(cfg.SOLVER.AUX),
        encoder_norm=encoder_norm,
        decoder_norm=decoder_norm,
        use_aspp=bool(d.USE_ASPP),
        enable_decoder=bool(d.ENABLE_DECODER),
        aspp_sep=bool(d.ASPP_WITH_SEP_CONV),
        decoder_sep=bool(d.DECODER_USE_SEP_CONV),
        output_stride=int(cfg.MODEL.OUTPUT_STRIDE),
        routes=SepconvRoutes.from_cfg(cfg),
    )
