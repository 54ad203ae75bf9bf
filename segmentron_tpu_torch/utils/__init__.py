from .device import resolve_device
from .registry import Registry
from .score import SegmentationMetric, confusion_matrix_update

__all__ = [
    "Registry",
    "SegmentationMetric",
    "confusion_matrix_update",
    "resolve_device",
]
