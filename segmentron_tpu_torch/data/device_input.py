"""Host side of the train augmentation on the device (counterpart of
``segmentron_tpu/data/device_input.py``).

The host decodes, draws the augmentation's parameters from the same
per-(seed, epoch, index) generator and in the same order as the host
augment (``draw_train_params``), and ships the uint8 source padded to a
static canvas, the class-mapped int16 mask, the geometry, the blur sigma
and PIL's exact nearest-neighbour source rows and columns of the mask's
crop. The train step resamples, crops, flips, blurs and normalizes on
the device (``ops/preprocess.py::DeviceAugment``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
from PIL import Image

__all__ = ["DeviceInput", "draw_train_params", "pil_nearest_indices", "resolve_canvas"]


def draw_train_params(rng, w: int, h: int, base_size: int, crop_size: int):
    """The host augment's draws in its order (flip, short side, crop
    corner, blur): (flip, oh, ow, x1, y1, blur_sigma)."""
    flip = rng.random() < 0.5
    short_size = rng.randint(int(base_size * 0.5), int(base_size * 2.0))
    if h > w:
        ow = short_size
        oh = int(1.0 * h * ow / w)
    else:
        oh = short_size
        ow = int(1.0 * w * oh / h)
    w2, h2 = max(ow, crop_size), max(oh, crop_size)  # padded only below the crop
    x1 = rng.randint(0, w2 - crop_size)
    y1 = rng.randint(0, h2 - crop_size)
    blur_sigma = 0.0
    if rng.random() < 0.5:
        blur_sigma = rng.random()  # PIL's radius is the Gaussian's sigma
    return flip, oh, ow, x1, y1, blur_sigma


def pil_nearest_indices(src: int, dst: int) -> np.ndarray:
    """PIL's NEAREST source index of each output position of a 1-D
    ``src -> dst`` resize, read from PIL by resizing an index ramp (the
    resize is separable, so the ramps give the 2-D mask resize exactly)."""
    ramp = np.arange(src, dtype=np.int32).reshape(1, src)
    out = Image.fromarray(ramp, mode="I").resize((dst, 1), Image.NEAREST)
    return np.asarray(out, np.int32).reshape(dst)


def resolve_canvas(dataset) -> Optional[Tuple[int, int]]:
    """The static (H, W) source canvas: ``cfg.DATASET.DEVICE_CANVAS``,
    else the dataset's ``DEVICE_CANVAS``, else None (host augment)."""
    from ..config import cfg

    override = tuple(cfg.DATASET.DEVICE_CANVAS)
    if len(override) == 2:
        return int(override[0]), int(override[1])
    canvas = getattr(dataset, "DEVICE_CANVAS", None)
    if canvas:
        return int(canvas[0]), int(canvas[1])
    return None


def _to_u8(img) -> np.ndarray:
    arr = np.asarray(img.convert("RGB") if hasattr(img, "convert") else img, np.uint8)
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, -1)
    return arr


class DeviceInput:
    """Builds a dataset's device-augment items. ``pad_label`` is the
    class id of the mask's pad: ``MASK_PAD_FILL`` through the dataset's
    own ``_mask_transform``, as the host path pads the raw mask and then
    maps it."""

    def __init__(self, dataset, canvas):
        self.canvas = tuple(canvas)
        fill = np.full((1, 1), dataset.MASK_PAD_FILL, np.int32)
        self.pad_label = int(np.asarray(
            dataset._mask_transform(Image.fromarray(fill, mode="I"))).reshape(-1)[0])

    def build_train_item(self, dataset, img, mask, rng) -> dict:
        """One sample: the canvas, the mapped mask, ``aug_geom`` [h, w, oh,
        ow, x1, y1, flip], ``aug_sigma`` and the mask crop's ``row_sel`` /
        ``col_sel`` (-1 where the crop is pad; columns mirrored for a
        flip)."""
        sh, sw = self.canvas
        arr = _to_u8(img)
        h, w = arr.shape[:2]
        if h > sh or w > sw:
            raise ValueError(
                f"source {h}x{w} exceeds the device-augment canvas {sh}x{sw}: set "
                "DATASET.DEVICE_CANVAS to cover the largest source (or TPU.DEVICE_AUGMENT False)")
        flip, oh, ow, x1, y1, sigma = draw_train_params(
            rng, w, h, dataset.base_size, dataset.crop_size)
        crop = dataset.crop_size

        image = np.zeros((sh, sw, 3), np.uint8)
        image[:h, :w] = arr
        m = np.asarray(dataset._mask_transform(mask), np.int32)
        mask_c = np.full((sh, sw), self.pad_label, np.int16)
        mask_c[:h, :w] = m.astype(np.int16)

        rowmap = pil_nearest_indices(h, oh)
        colmap = pil_nearest_indices(w, ow)
        row_sel = np.full((crop,), -1, np.int32)
        nr = max(min(crop, oh - y1), 0)
        row_sel[:nr] = rowmap[y1:y1 + nr]
        col_sel = np.full((crop,), -1, np.int32)
        nc = max(min(crop, ow - x1), 0)
        cols = colmap[x1:x1 + nc]
        col_sel[:nc] = (w - 1 - cols) if flip else cols
        return {
            "image": image,
            "mask": mask_c,
            "aug_geom": np.asarray([h, w, oh, ow, x1, y1, int(flip)], np.int32),
            "aug_sigma": np.float32(sigma),
            "row_sel": row_sel,
            "col_sel": col_sel,
        }
