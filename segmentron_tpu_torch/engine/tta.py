"""Multi-scale + flip TTA and sliding-window inference (counterpart of
``segmentron_tpu/engine/tta.py``).

- Sliding windows: a fixed window (``TEST.CROP_SIZE``) on a grid with
  stride ``ceil(crop * 2/3)``, the image zero-padded up to the window
  where it is smaller; every window of an image goes through the
  predictor as one batch, and the window logits are summed into a canvas
  divided by the count of windows over each pixel.
- Multi-scale: each scale's size is ``int(h * s + 0.5)``, reached by an
  align-corners bilinear resize only where the size changes; with
  ``flip`` each scale also runs mirrored in W (its probabilities mirrored
  back). The f32 softmax of every run, resized back to (h, w), is summed.
- A raw uint8 image is normalized first (``cfg.DATASET.MEAN/STD``), so
  the pad and the resizes act on normalized values: the apron is a
  normalized zero.

``predict_fn(images) -> logits`` takes NHWC images and returns NHWC
logits (``engine/steps.py::make_predict_fn``). The JAX package compiles
one program per shape bucket and keeps a registry of predictors for its
cache; here each call runs eagerly.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F

from ..config import cfg
from ..ops import maybe_normalize

__all__ = ["multi_scale_predict", "predict_sliding", "predict_whole"]


def predict_whole(predict_fn: Callable, image: torch.Tensor) -> torch.Tensor:
    """image (N, H, W, 3) -> logits (N, H, W, C)."""
    return predict_fn(image)


def _normalize(image: torch.Tensor) -> torch.Tensor:
    return maybe_normalize(image, list(cfg.DATASET.MEAN), list(cfg.DATASET.STD))


def _grid_positions(ph: int, pw: int, crop: int, stride: int):
    rows = max(int(math.ceil((ph - crop) / stride)) + 1, 1)
    cols = max(int(math.ceil((pw - crop) / stride)) + 1, 1)
    return [(min(r * stride, ph - crop), min(c * stride, pw - crop))
            for r in range(rows) for c in range(cols)]


def _resize_nhwc(x: torch.Tensor, size, align_corners: bool) -> torch.Tensor:
    """Align-corners bilinear resize of NHWC ``x`` (f32 math)."""
    y = F.interpolate(x.permute(0, 3, 1, 2).float(), size=(int(size[0]), int(size[1])),
                      mode="bilinear", align_corners=align_corners)
    return y.permute(0, 2, 3, 1).to(x.dtype)


def _sliding(predict_fn: Callable, image: torch.Tensor, crop: int, stride: int,
             nclass: int) -> torch.Tensor:
    """(1, h, w, ch) normalized image -> (1, h, w, nclass) f32 logits."""
    _, h, w, _ = image.shape
    pad_h, pad_w = max(crop - h, 0), max(crop - w, 0)
    ph, pw = h + pad_h, w + pad_w
    grid = _grid_positions(ph, pw, crop, stride)
    padded = F.pad(image, (0, 0, 0, pad_w, 0, pad_h))
    windows = torch.cat([padded[:, y0:y0 + crop, x0:x0 + crop] for y0, x0 in grid], dim=0)
    logits = predict_fn(windows).float()
    canvas = torch.zeros((ph, pw, nclass), dtype=torch.float32, device=logits.device)
    count = torch.zeros((ph, pw, 1), dtype=torch.float32, device=logits.device)
    for i, (y0, x0) in enumerate(grid):
        canvas[y0:y0 + crop, x0:x0 + crop] += logits[i]
        count[y0:y0 + crop, x0:x0 + crop] += 1.0
    return (canvas / torch.clamp(count, min=1.0))[None, :h, :w]


def predict_sliding(predict_fn: Callable, image: torch.Tensor, crop_size: int, nclass: int,
                    stride_ratio: float = 2.0 / 3.0) -> torch.Tensor:
    """Sliding-window logits (N, H, W, nclass), each image's windows in one
    batch."""
    stride = int(math.ceil(crop_size * stride_ratio))
    image = _normalize(image)
    return torch.cat([_sliding(predict_fn, image[i:i + 1], crop_size, stride, nclass)
                      for i in range(image.shape[0])], dim=0)


def multi_scale_predict(predict_fn: Callable, image: torch.Tensor, nclass: int,
                        scales: Sequence[float] = (1.0,), flip: bool = False,
                        crop_size: Optional[int] = None,
                        align_corners: bool = True) -> torch.Tensor:
    """Softmax probabilities summed over scales (and flips) at the source
    resolution: (N, H, W, nclass) f32. A scaled image larger than
    ``crop_size`` on either side runs by sliding windows."""
    image = _normalize(image)
    n, h, w, _ = image.shape
    total = torch.zeros((n, h, w, nclass), dtype=torch.float32, device=image.device)
    for s in scales:
        sh, sw = int(h * s + 0.5), int(w * s + 0.5)
        scaled = image if (sh, sw) == (h, w) else _resize_nhwc(image, (sh, sw), align_corners)
        variants = [scaled, scaled.flip(2)] if flip else [scaled]
        for vi, img in enumerate(variants):
            if crop_size is not None and max(sh, sw) > crop_size:
                stride = int(math.ceil(crop_size * 2.0 / 3.0))
                logits = torch.cat([_sliding(predict_fn, img[i:i + 1], crop_size, stride, nclass)
                                    for i in range(n)], dim=0)
            else:
                logits = predict_fn(img)
            probs = torch.softmax(logits.float(), dim=-1)
            if vi == 1:
                probs = probs.flip(2)
            if tuple(probs.shape[1:3]) != (h, w):
                probs = _resize_nhwc(probs, (h, w), align_corners)
            total = total + probs
    return total
