from .basic import ConvBNReLU, SeparableConv2d, SepconvRoutes, conv2d
from .batch_norm import BatchNorm2d, NormConfig, norm_from_cfg, running_stats_frozen
from .module import ASPP, Dropout2d, FCNHead

__all__ = [
    "ASPP",
    "BatchNorm2d",
    "ConvBNReLU",
    "Dropout2d",
    "FCNHead",
    "NormConfig",
    "SeparableConv2d",
    "SepconvRoutes",
    "conv2d",
    "norm_from_cfg",
    "running_stats_frozen",
]
