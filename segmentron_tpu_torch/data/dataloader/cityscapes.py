"""Cityscapes (counterpart of ``segmentron_tpu/data/dataloader/cityscapes.py``).

``leftImg8bit/<split>/<city>/*_leftImg8bit.png`` paired with
``gtFine/<split>/<city>/*_gtFine_labelIds.png``; the 34 raw label ids map
to the 19 train ids through a lookup table, every other id to -1
(ignore). Decoded with PIL, the labels mapped by a numpy lookup (the
JAX package's native ``remap_labels`` gives the same values). Every
source is 1024x2048: ``DEVICE_CANVAS``, the static canvas of the train
augmentation on the device.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np
from PIL import Image

from .seg_data_base import SegmentationDataset

__all__ = ["CitySegmentation"]

# raw label id -> train id, in the order of the official scripts
_VALID_CLASSES = [7, 8, 11, 12, 13, 17, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 31, 32, 33]


def _build_lut() -> np.ndarray:
    lut = np.full((256,), -1, np.int32)
    for train_id, raw_id in enumerate(_VALID_CLASSES):
        lut[raw_id] = train_id
    return lut


_LUT = _build_lut()


class CitySegmentation(SegmentationDataset):
    NUM_CLASS = 19
    DEVICE_CANVAS = (1024, 2048)

    CLASSES = (
        "road", "sidewalk", "building", "wall", "fence", "pole", "traffic light",
        "traffic sign", "vegetation", "terrain", "sky", "person", "rider", "car", "truck",
        "bus", "train", "motorcycle", "bicycle",
    )

    def __init__(self, root: str = "datasets/cityscapes", split: str = "train", mode=None,
                 **kwargs):
        super().__init__(root, split, mode, **kwargs)
        self.images, self.masks = _get_city_pairs(self.root, self.split)
        if not self.images:
            raise RuntimeError(f"Found 0 images in {os.path.join(root, 'leftImg8bit', split)}")

    def __len__(self) -> int:
        return len(self.images)

    def _mask_transform(self, mask) -> np.ndarray:
        raw = np.asarray(mask)
        if raw.dtype == np.uint8:  # the labelIds PNGs: every value indexes the table
            return _LUT[raw]
        return _LUT[np.clip(raw.astype(np.int64), 0, 255)].astype(np.int32)

    def __getitem__(self, index: int):
        name = os.path.basename(self.images[index])
        with Image.open(self.images[index]) as f:
            img = f.convert("RGB")
        if self.mode == "test":
            return self.transform_pair(img, None)[0], None, name
        with Image.open(self.masks[index]) as f:
            f.load()
            mask = f.copy()
        img_t, mask_t = self.transform_pair(img, mask, index)
        return img_t, mask_t, name


def _get_city_pairs(folder: str, split: str) -> Tuple[List[str], List[str]]:
    img_paths, mask_paths = [], []
    img_folder = os.path.join(folder, "leftImg8bit", split)
    mask_folder = os.path.join(folder, "gtFine", split)
    if not os.path.isdir(img_folder):
        return [], []
    for city in sorted(os.listdir(img_folder)):
        cdir = os.path.join(img_folder, city)
        for fname in sorted(os.listdir(cdir)):
            if not fname.endswith(".png"):
                continue
            img_paths.append(os.path.join(cdir, fname))
            mask_name = fname.replace("leftImg8bit", "gtFine_labelIds")
            mask_paths.append(os.path.join(mask_folder, city, mask_name))
    return img_paths, mask_paths
