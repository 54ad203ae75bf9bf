"""Dataset base with the joint image/mask transforms (counterpart of
``segmentron_tpu/data/dataloader/seg_data_base.py``), on PIL and numpy.

- ``train``: random hflip -> random scale of the short side in
  [0.5, 2.0) x ``base_size`` -> pad to ``crop_size`` (image with 0, the
  raw mask with ``MASK_PAD_FILL``) -> random crop -> Gaussian blur with a
  random radius half the time -> normalize; the draws come from
  ``per_sample_rng(index)``, so the stream depends on (seed, epoch,
  index) alone. With ``device_input`` set (the Trainer's
  ``TPU.DEVICE_AUGMENT``), the item is instead the raw canvas and the
  draws for the augmentation in the train step
  (``data/device_input.py``).
- ``val``: the short side resized to ``crop_size``, then a centre crop.
- ``testval``: the whole image and mask: the image as raw uint8 HWC when
  it is normalized on the device (``cfg.TPU.DEVICE_NORMALIZE``), else as
  normalized f32 HWC.
- ``test``: the image only.

Masks are int32 class ids with ignore = -1. The JAX package's native
host routes (``_sync_transform_native``, ``fused_resize_normalize``) are
not ported: this is its PIL path, which those routes match in their
draws.
"""

from __future__ import annotations

import os
import random
from typing import Optional, Tuple

import numpy as np
from PIL import Image, ImageFilter

from ...config import cfg

__all__ = ["SegmentationDataset"]


class SegmentationDataset:
    NUM_CLASS: int = 0
    MASK_PAD_FILL: int = 0  # raw-space pad value of the train crop's mask

    def __init__(self, root: str = "", split: str = "val", mode: Optional[str] = None,
                 base_size: Optional[int] = None, crop_size: Optional[int] = None,
                 device_normalize: Optional[bool] = None):
        # a relative root resolves against cfg.ROOT_PATH, as in the JAX package
        self.root = (os.path.join(cfg.ROOT_PATH, root)
                     if root and cfg.ROOT_PATH and not os.path.isabs(root) else root)
        self.split = split
        self.mode = mode if mode is not None else split
        if self.mode not in ("train", "val", "testval", "test"):
            raise ValueError(f"unknown dataset mode {self.mode!r}")
        self.base_size = base_size if base_size is not None else cfg.TRAIN.BASE_SIZE
        self.crop_size = crop_size if crop_size is not None else cfg.TRAIN.CROP_SIZE
        self.device_normalize = (
            bool(cfg.TPU.DEVICE_NORMALIZE) if device_normalize is None else device_normalize
        )
        self.mean = np.asarray(cfg.DATASET.MEAN, np.float32)
        self.std = np.asarray(cfg.DATASET.STD, np.float32)
        self._epoch = 0
        self._rng = random.Random(cfg.SEED)  # when no index is given
        # data/device_input.py's DeviceInput: set by the Trainer when the
        # train augmentation runs in the step
        self.device_input = None

    def set_epoch(self, epoch: int) -> None:
        """Advance the augmentation stream (the DataLoader calls it)."""
        self._epoch = int(epoch)

    def per_sample_rng(self, index: int) -> random.Random:
        """The generator of sample ``index``'s draws this epoch: a
        function of (``cfg.SEED``, epoch, index) only, so the stream does
        not depend on the loader's thread scheduling."""
        mix = (cfg.SEED * 1_000_003 + self._epoch) * 1_000_003 + int(index)
        return random.Random(mix)

    def __len__(self) -> int:  # pragma: no cover - abstract
        raise NotImplementedError

    def __getitem__(self, index: int):  # pragma: no cover - abstract
        raise NotImplementedError

    @property
    def num_class(self) -> int:
        return self.NUM_CLASS

    # ----------------------------------------------------------- transforms
    def _img_transform(self, img) -> np.ndarray:
        """PIL or uint8 HWC -> normalized f32 HWC, ``(x / 255 - mean) / std``."""
        arr = np.asarray(img).astype(np.float32) / 255.0
        if arr.ndim == 2:
            arr = np.stack([arr] * 3, -1)
        return (arr - self.mean) / self.std

    def _mask_transform(self, mask) -> np.ndarray:
        return np.asarray(mask, np.int32)

    def _sync_transform(self, img: Image.Image, mask: Image.Image,
                        rng=None) -> Tuple[np.ndarray, np.ndarray]:
        rng = rng if rng is not None else self._rng
        crop_size = self.crop_size
        if rng.random() < 0.5:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
            mask = mask.transpose(Image.FLIP_LEFT_RIGHT)
        short_size = rng.randint(int(self.base_size * 0.5), int(self.base_size * 2.0))
        w, h = img.size
        if h > w:
            ow = short_size
            oh = int(1.0 * h * ow / w)
        else:
            oh = short_size
            ow = int(1.0 * w * oh / h)
        img = img.resize((ow, oh), Image.BILINEAR)
        mask = mask.resize((ow, oh), Image.NEAREST)
        if short_size < crop_size:
            padh = crop_size - oh if oh < crop_size else 0
            padw = crop_size - ow if ow < crop_size else 0
            img = _pad(img, padw, padh, fill=0)
            # the raw mask is padded (before the class mapping), as the
            # reference does: a dataset whose raw 0 is unlabelled maps it to -1
            mask = _pad(mask, padw, padh, fill=self.MASK_PAD_FILL)
        w, h = img.size
        x1 = rng.randint(0, w - crop_size)
        y1 = rng.randint(0, h - crop_size)
        img = img.crop((x1, y1, x1 + crop_size, y1 + crop_size))
        mask = mask.crop((x1, y1, x1 + crop_size, y1 + crop_size))
        if rng.random() < 0.5:
            img = img.filter(ImageFilter.GaussianBlur(radius=rng.random()))
        return self._img_transform(img), self._mask_transform(mask)

    def _val_sync_transform(self, img: Image.Image,
                            mask: Image.Image) -> Tuple[np.ndarray, np.ndarray]:
        outsize = self.crop_size
        w, h = img.size
        if w > h:
            oh = outsize
            ow = int(1.0 * w * oh / h)
        else:
            ow = outsize
            oh = int(1.0 * h * ow / w)
        x1 = int(round((ow - outsize) / 2.0))
        y1 = int(round((oh - outsize) / 2.0))
        img_t = self._img_transform(img.resize((ow, oh), Image.BILINEAR))
        mask_t = self._mask_transform(mask.resize((ow, oh), Image.NEAREST))
        return (img_t[y1:y1 + outsize, x1:x1 + outsize],
                mask_t[y1:y1 + outsize, x1:x1 + outsize])

    def _testval_transform(self, img, mask):
        mask_t = self._mask_transform(mask)
        if self.device_normalize:
            return np.array(img, dtype=np.uint8), mask_t
        return self._img_transform(img), mask_t

    def transform_pair(self, img, mask, index: Optional[int] = None):
        """Dispatch by mode: (image, int32 mask | None), or in device-input
        train mode (item dict, None), the dict carrying the raw uint8
        canvas and the augmentation's draws. ``index`` keys the sample's
        generator."""
        if self.mode == "train":
            rng = self.per_sample_rng(index) if index is not None else self._rng
            if self.device_input is not None:
                return self.device_input.build_train_item(self, img, mask, rng), None
            return self._sync_transform(img, mask, rng)
        if self.mode == "val":
            return self._val_sync_transform(img, mask)
        if self.mode == "testval":
            return self._testval_transform(img, mask)
        return self._img_transform(img), None


def _pad(img: Image.Image, padw: int, padh: int, fill) -> Image.Image:
    """Pad right and bottom. PIL has no negative fill for 'L'/'P', so a
    mask padded with -1 goes through numpy int32."""
    if padw <= 0 and padh <= 0:
        return img
    if fill == -1:
        arr = np.asarray(img, np.int32)
        arr = np.pad(arr, ((0, max(padh, 0)), (0, max(padw, 0))), constant_values=-1)
        return Image.fromarray(arr, mode="I")
    w, h = img.size
    out = Image.new(img.mode, (w + max(padw, 0), h + max(padh, 0)), fill)
    out.paste(img, (0, 0))
    return out
