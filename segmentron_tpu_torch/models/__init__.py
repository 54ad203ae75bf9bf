from .model_zoo import MODEL_REGISTRY, get_segmentation_model
from .segbase import SegBaseModel, init_weights
from . import deeplabv3_plus  # noqa: F401  (registers DeepLabV3_Plus)

__all__ = ["MODEL_REGISTRY", "SegBaseModel", "get_segmentation_model", "init_weights"]
