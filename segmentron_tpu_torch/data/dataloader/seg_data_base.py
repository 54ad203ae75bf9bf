"""Dataset base, evaluation transforms (counterpart of the testval part
of ``segmentron_tpu/data/dataloader/seg_data_base.py``).

``testval`` yields the whole image and mask untouched: the image as raw
uint8 HWC when it is normalized on the device (``cfg.TPU.DEVICE_NORMALIZE``,
``ops/preprocess.py``), else as normalized f32 HWC; the mask as int32
class ids with ignore = -1.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ...config import cfg

__all__ = ["SegmentationDataset"]


class SegmentationDataset:
    NUM_CLASS: int = 0

    def __init__(self, root: str = "", split: str = "val", mode: Optional[str] = None,
                 device_normalize: Optional[bool] = None):
        self.root = root
        self.split = split
        self.mode = mode if mode is not None else split
        if self.mode != "testval":
            raise NotImplementedError(
                f"dataset mode {self.mode!r} is not ported yet (only 'testval')"
            )
        self.device_normalize = (
            bool(cfg.TPU.DEVICE_NORMALIZE) if device_normalize is None else device_normalize
        )
        self.mean = np.asarray(cfg.DATASET.MEAN, np.float32)
        self.std = np.asarray(cfg.DATASET.STD, np.float32)

    def __len__(self) -> int:  # pragma: no cover - abstract
        raise NotImplementedError

    def __getitem__(self, index: int):  # pragma: no cover - abstract
        raise NotImplementedError

    @property
    def num_class(self) -> int:
        return self.NUM_CLASS

    def transform_pair(self, img: np.ndarray, mask: np.ndarray):
        """uint8 HWC image and mask -> (image, int32 mask)."""
        mask = np.asarray(mask, np.int32)
        if self.device_normalize:
            return np.ascontiguousarray(img, np.uint8), mask
        return (img.astype(np.float32) / 255.0 - self.mean) / self.std, mask
