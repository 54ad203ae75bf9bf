"""Pretrained backbone weights: the lookup of
``segmentron_tpu/utils/download.py::resolve_pretrained`` with no
download. Loading a SegmenTron ``.pth`` into the port is not ported
yet, so a file that is found raises ``NotImplementedError``."""

from __future__ import annotations

import os
from typing import Optional

__all__ = ["cached_weight_path", "default_cache_dir", "resolve_pretrained"]


def default_cache_dir() -> str:
    return os.environ.get("SEGMENTRON_CACHE", os.path.expanduser("~/.cache/segmentron_tpu"))


def cached_weight_path(backbone: str) -> Optional[str]:
    """Path of cached weights for ``backbone`` (``.pth``, ``.pt`` or
    ``.npz`` in the cache directory), if present."""
    for ext in (".pth", ".pt", ".npz"):
        path = os.path.join(default_cache_dir(), backbone + ext)
        if os.path.isfile(path):
            return path
    return None


def resolve_pretrained(backbone: str, explicit_path: str = "") -> None:
    """The explicit path, else the cache; fetches nothing. Returns None
    (train from scratch) when neither has weights. Raises
    ``FileNotFoundError`` for an explicit path that does not exist and
    ``NotImplementedError`` for weights that are found, which the port
    cannot load yet."""
    if explicit_path and not os.path.isfile(explicit_path):
        raise FileNotFoundError(f"TRAIN.BACKBONE_PRETRAINED_PATH={explicit_path!r} not found")
    path = explicit_path or cached_weight_path(backbone)
    if path:
        raise NotImplementedError(
            f"pretrained weights for {backbone} at {path!r}: loading them is not ported to "
            "PyTorch yet (set TRAIN.BACKBONE_PRETRAINED False to train from scratch)")
    return None
