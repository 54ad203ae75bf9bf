from .build import BACKBONE_REGISTRY, get_segmentation_backbone
from . import resnet, xception  # noqa: F401  (register resnet18..152c, xception65)

__all__ = ["BACKBONE_REGISTRY", "get_segmentation_backbone"]
