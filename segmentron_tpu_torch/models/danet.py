"""DANet, dual attention (counterpart of ``segmentron_tpu/models/danet.py``).

On c4, a position-attention branch (PAM: a (HW x HW) affinity softmax
through ``ops/attention.py::spatial_attention``, the flash kernel for
large HW under ``cfg.TPU.USE_PALLAS``) and a channel-attention branch
(CAM: a (C x C) affinity, dense), each between two 3x3 ConvBNReLUs;
their sum goes to the classifier. With ``aux`` the two branches have
classifiers of their own (``p_out``, ``c_out``).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..modules import ConvBNReLU, Dropout2d, NormConfig, conv2d
from ..ops import resize_bilinear
from ..ops.attention import spatial_attention
from .model_zoo import MODEL_REGISTRY
from .segbase import SegBaseModel

__all__ = ["CAM", "DANet", "PAM"]


def flatten(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> contiguous (N, H*W, C), the attention layout (a view for
    ``channels_last`` memory)."""
    n, c, h, w = x.shape
    return x.permute(0, 2, 3, 1).reshape(n, h * w, c).contiguous()


def unflatten(y: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(N, H*W, C) -> NCHW (in ``channels_last`` memory)."""
    return y.reshape(y.shape[0], h, w, y.shape[-1]).permute(0, 3, 1, 2)


class PAM(nn.Module):
    """Position attention: ``gamma * attention(query, key, value) + x``,
    with q and k of c // 8 channels, unscaled."""

    def __init__(self, channels: int, use_pallas: bool = False):
        super().__init__()
        self.use_pallas = use_pallas
        self.query = conv2d(channels, channels // 8, 1, 1, 0, bias=True)
        self.key = conv2d(channels, channels // 8, 1, 1, 0, bias=True)
        self.value = conv2d(channels, channels, 1, 1, 0, bias=True)
        self.gamma = nn.Parameter(torch.zeros(()))

    def forward(self, x):
        h, w = x.shape[2:]
        out = spatial_attention(flatten(self.query(x)), flatten(self.key(x)),
                                flatten(self.value(x)), use_pallas=self.use_pallas)
        return self.gamma * unflatten(out, h, w) + x


class CAM(nn.Module):
    """Channel attention: ``gamma * softmax(max(E) - E) . x + x`` with the
    (C x C) energy E of x, products and softmax in f32."""

    def __init__(self):
        super().__init__()
        self.gamma = nn.Parameter(torch.zeros(()))

    def forward(self, x):
        h, w = x.shape[2:]
        flat = flatten(x).float()
        energy = torch.bmm(flat.transpose(1, 2), flat)
        energy = energy.amax(dim=-1, keepdim=True) - energy
        attn = torch.softmax(energy, dim=-1)
        out = torch.bmm(flat, attn.transpose(1, 2)).to(x.dtype)
        return self.gamma * unflatten(out, h, w) + x


class DANet(SegBaseModel):
    def __init__(self, nclass: int, backbone: str = "resnet50", aux: bool = False,
                 encoder_norm: NormConfig = NormConfig(),
                 decoder_norm: NormConfig = NormConfig(), use_pallas: bool = False):
        super().__init__(nclass, backbone, aux, encoder_norm, decoder_norm)
        norm = self.decoder_norm
        c4 = self.backbone.channels[3]
        inter = c4 // 4
        self.conv_p1 = ConvBNReLU(c4, inter, 3, norm=norm)
        self.pam = PAM(inter, use_pallas=use_pallas)
        self.conv_p2 = ConvBNReLU(inter, inter, 3, norm=norm)
        self.conv_c1 = ConvBNReLU(c4, inter, 3, norm=norm)
        self.cam = CAM()
        self.conv_c2 = ConvBNReLU(inter, inter, 3, norm=norm)
        self.dropout = Dropout2d(0.1)
        self.out = conv2d(inter, nclass, 1, 1, 0, bias=True)
        if aux:
            self.p_out = conv2d(inter, nclass, 1, 1, 0, bias=True)
            self.c_out = conv2d(inter, nclass, 1, 1, 0, bias=True)

    def forward(self, x):
        """(N, H, W, 3) -> ((N, H, W, nclass), [p_out, c_out])."""
        size = x.shape[1:3]
        c1, c2, c3, c4 = self.backbone(x.permute(0, 3, 1, 2))
        pa = self.conv_p2(self.pam(self.conv_p1(c4)))
        ca = self.conv_c2(self.cam(self.conv_c1(c4)))
        outputs = [self.out(self.dropout(pa + ca))]
        if self.aux:
            outputs.append(self.p_out(self.dropout(pa)))
            outputs.append(self.c_out(self.dropout(ca)))
        return tuple(resize_bilinear(o, size, align_corners=True).permute(0, 2, 3, 1)
                     for o in outputs)


@MODEL_REGISTRY.register(name="DANet")
def _danet(nclass, encoder_norm, decoder_norm):
    from ..config import cfg

    return DANet(
        nclass=nclass,
        backbone=cfg.MODEL.BACKBONE.lower(),
        aux=bool(cfg.SOLVER.AUX),
        encoder_norm=encoder_norm,
        decoder_norm=decoder_norm,
        use_pallas=bool(cfg.TPU.USE_PALLAS),
    )
