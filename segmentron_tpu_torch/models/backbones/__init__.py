from .build import BACKBONE_REGISTRY, get_segmentation_backbone
from . import xception  # noqa: F401  (registers xception65)

__all__ = ["BACKBONE_REGISTRY", "get_segmentation_backbone"]
