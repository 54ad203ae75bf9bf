"""Synthetic dataset (counterpart of
``segmentron_tpu/data/dataloader/synthetic.py``): the same deterministic
images and masks from the same numpy draws, with no files."""

from __future__ import annotations

import numpy as np
from PIL import Image

from .seg_data_base import SegmentationDataset

__all__ = ["SyntheticSegmentation"]


class SyntheticSegmentation(SegmentationDataset):
    NUM_CLASS = 19

    def __init__(self, root: str = "", split: str = "val", mode=None, length: int = 32,
                 image_size=(512, 512), num_class: int = None, **kwargs):
        super().__init__(root, split, mode, **kwargs)
        self.length = length
        self.image_size = image_size
        if num_class is not None:
            self.NUM_CLASS = num_class

    def __len__(self) -> int:
        return self.length

    def _make_pair(self, index: int):
        rng = np.random.RandomState(index + (0 if self.split == "train" else 10_000))
        h, w = self.image_size
        # blobby image whose mask is a deterministic function of it
        coarse = rng.rand(h // 32 + 1, w // 32 + 1)
        coarse = np.kron(coarse, np.ones((32, 32)))[:h, :w]
        img = np.stack(
            [coarse, np.roll(coarse, 7, 0), np.roll(coarse, 7, 1)], axis=-1
        )
        img = ((img + 0.05 * rng.rand(h, w, 3)) * 220).clip(0, 255).astype(np.uint8)
        mask = (coarse * self.NUM_CLASS).astype(np.uint8) % self.NUM_CLASS
        return Image.fromarray(img), Image.fromarray(mask)

    def __getitem__(self, index: int):
        img, mask = self._make_pair(index)
        if self.mode == "test":
            return self.transform_pair(img, None)[0], None, f"synthetic_{index}.png"
        img_t, mask_t = self.transform_pair(img, mask, index)
        return img_t, mask_t, f"synthetic_{index}.png"
