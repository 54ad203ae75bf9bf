from .basic import ConvBNReLU, SeparableConv2d, SepconvRoutes, conv2d
from .batch_norm import BatchNorm2d, NormConfig, norm_from_cfg
from .module import ASPP, FCNHead

__all__ = [
    "ASPP",
    "BatchNorm2d",
    "ConvBNReLU",
    "FCNHead",
    "NormConfig",
    "SeparableConv2d",
    "SepconvRoutes",
    "conv2d",
    "norm_from_cfg",
]
