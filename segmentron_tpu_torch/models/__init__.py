from .model_zoo import MODEL_REGISTRY, get_segmentation_model
from .segbase import SegBaseModel, init_weights
from . import danet, deeplabv3_plus, ocnet  # noqa: F401  (register DANet, DeepLabV3_Plus, OCNet)

__all__ = ["MODEL_REGISTRY", "SegBaseModel", "get_segmentation_model", "init_weights"]
