"""Model base (counterpart of ``segmentron_tpu/models/segbase.py``).

A segmentation model takes NHWC images and returns a tuple of NHWC
logit maps at input resolution, ``(main, *aux)``, as the JAX models do.
Inside, activations are NCHW in ``channels_last`` memory, so the
boundary permutes are free views. The backbone is the ``backbone``
submodule, named as the flax scope.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from ..modules import NormConfig
from .backbones import get_segmentation_backbone

__all__ = ["SegBaseModel", "init_weights"]


class SegBaseModel(nn.Module):
    """Shared fields and backbone of the zoo models."""

    def __init__(self, nclass: int = 19, backbone: str = "xception65", aux: bool = False,
                 encoder_norm: NormConfig = NormConfig(),
                 decoder_norm: NormConfig = NormConfig()):
        super().__init__()
        self.nclass = nclass
        self.aux = aux
        self.decoder_norm = decoder_norm
        self.backbone = get_segmentation_backbone(backbone, encoder_norm)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random init from ``generator``, as the JAX package initialises:
    conv weights LeCun-normal (std sqrt(1/fan_in)), conv biases 0, BN
    scale 1, bias 0, mean 0, var 1."""
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.weight[0].numel()
            w = torch.randn(m.weight.shape, generator=generator) / math.sqrt(fan_in)
            m.weight.copy_(w)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.BatchNorm2d, nn.GroupNorm)):
            m.reset_parameters()
    return model
