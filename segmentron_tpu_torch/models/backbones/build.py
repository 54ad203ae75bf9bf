"""Backbone registry (counterpart of ``segmentron_tpu/models/backbones/build.py``)."""

from __future__ import annotations

from ...modules import NormConfig
from ...utils.registry import Registry

BACKBONE_REGISTRY = Registry("BACKBONE")

__all__ = ["BACKBONE_REGISTRY", "get_segmentation_backbone"]


def get_segmentation_backbone(backbone: str, norm: NormConfig):
    """Instantiate a registered backbone module by name."""
    return BACKBONE_REGISTRY.get(backbone)(norm=norm)
