"""Basic conv blocks (counterpart of ``segmentron_tpu/modules/basic.py``).

NCHW modules (the models keep activations in ``channels_last`` memory).
Submodule names follow the JAX package's flax scopes (``conv``/``bn``;
``depthwise``/``dw_bn``/``pointwise``/``pw_bn``) so weights convert
mechanically (``utils/convert.py``).
"""

from __future__ import annotations

from typing import Optional

import torch.nn as nn

from .batch_norm import NormConfig

__all__ = ["conv2d", "ConvBNReLU", "SeparableConv2d"]


def conv2d(
    in_channels: int,
    out_channels: int,
    kernel_size: int = 3,
    stride: int = 1,
    padding: Optional[int] = None,
    dilation: int = 1,
    groups: int = 1,
    bias: bool = False,
) -> nn.Conv2d:
    """``nn.Conv2d`` with the reference's default padding
    ``dilation * (k - 1) // 2`` ('same' for odd kernels)."""
    if padding is None:
        padding = dilation * (kernel_size - 1) // 2
    return nn.Conv2d(
        in_channels, out_channels, kernel_size, stride, padding, dilation,
        groups=groups, bias=bias,
    )


class ConvBNReLU(nn.Module):
    """Conv -> norm -> ReLU (``relu=False`` drops the activation)."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: int = 3,
        stride: int = 1,
        padding: Optional[int] = None,
        dilation: int = 1,
        norm: NormConfig = NormConfig(),
        relu: bool = True,
    ):
        super().__init__()
        self.conv = conv2d(in_channels, out_channels, kernel_size, stride, padding, dilation)
        self.bn = norm.make(out_channels)
        self.act = nn.ReLU() if relu else nn.Identity()

    def forward(self, x):
        return self.act(self.bn(self.conv(x)))


class SeparableConv2d(nn.Module):
    """[ReLU] -> depthwise 3x3 -> norm -> pointwise 1x1 -> norm.

    ``relu_first=False`` is the aligned-Xception order (no ReLU inside);
    the stride and dilation apply to the depthwise conv."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: int = 3,
        stride: int = 1,
        dilation: int = 1,
        norm: NormConfig = NormConfig(),
        relu_first: bool = True,
    ):
        super().__init__()
        self.relu_first = relu_first
        self.depthwise = conv2d(
            in_channels, in_channels, kernel_size, stride, None, dilation,
            groups=in_channels,
        )
        self.dw_bn = norm.make(in_channels)
        self.pointwise = conv2d(in_channels, out_channels, 1, 1, 0)
        self.pw_bn = norm.make(out_channels)

    def forward(self, x):
        if self.relu_first:
            x = x.relu()
        x = self.dw_bn(self.depthwise(x))
        return self.pw_bn(self.pointwise(x))
