"""Input preprocessing on the device (counterpart of
``segmentron_tpu/ops/preprocess.py``): the uint8 normalize, and the
train augmentation (random scale, crop, flip, blur, normalize) as
batched tensor code in the train step.

The resample is two dense f32 matrix products a sample (width, then
height) with PIL-BILINEAR triangle weights (support widened by the scale
when downscaling, weights normalized to sum 1), built on the device from
the host's draws. The JAX package computes them at
``precision="highest"``; here ``torch.matmul`` runs them in f32 with
TF32 off for the call (``_no_tf32``). The blur is seven shifted slices a
pass with a per-sample kernel (radius ``max(1, int(3 sigma + 0.5))``,
clamp to edge, horizontal then vertical). Masks are taken by whole rows
and columns from PIL's own nearest-neighbour indices, -1 marking the
pad.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import torch

__all__ = [
    "DeviceAugment",
    "augment_images",
    "augment_masks",
    "maybe_normalize",
    "normalize_u8",
    "resample_matrix",
]


def normalize_u8(
    images: torch.Tensor, mean: Sequence[float], std: Sequence[float]
) -> torch.Tensor:
    """uint8 RGB (..., 3) -> f32 ``(x/255 - mean)/std``, in that order."""
    mean = torch.tensor(mean, dtype=torch.float32, device=images.device)
    std = torch.tensor(std, dtype=torch.float32, device=images.device)
    return (images.float() / 255.0 - mean) / std


def maybe_normalize(images: torch.Tensor, mean, std) -> torch.Tensor:
    """Normalize iff ``images`` are raw uint8; float inputs (normalized
    on the host) pass through untouched."""
    if images.dtype != torch.uint8:
        return images
    return normalize_u8(images, mean, std)


@contextlib.contextmanager
def _no_tf32():
    """f32 products in full f32 on CUDA for the block (TF32 off), the
    previous setting restored after it."""
    previous = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = previous


def resample_matrix(src_static: int, out_len: int, src_true: torch.Tensor,
                    dst_true: torch.Tensor, offset: torch.Tensor,
                    flip: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, src_static, out_len) f32 resample matrices: column ``j`` of
    sample b holds the PIL-BILINEAR weights of output pixel ``offset + j``
    of a ``src_true -> dst_true`` resize (each argument a (B,) tensor).
    Rows past ``src_true`` (the canvas' pad) and columns at or past
    ``dst_true`` (the crop's pad) are zero; with ``flip`` (nonzero) the
    mirror folds into the source index. A column whose taps are all zero
    takes the nearest source pixel."""
    dev = src_true.device
    src = src_true.float()[:, None, None]
    dst = dst_true.float()[:, None, None]
    off = offset[:, None, None]
    scale = src / dst
    inv = torch.clamp(1.0 / scale, max=1.0)
    j = torch.arange(out_len, dtype=torch.float32, device=dev)[None, None, :]
    centers = (off.float() + j + 0.5) * scale  # (B, 1, out_len)
    s = torch.arange(src_static, dtype=torch.float32, device=dev)[None, :, None]
    u = s.expand(src_true.shape[0], src_static, 1)
    if flip is not None:
        u = torch.where(flip[:, None, None] > 0, src - 1.0 - s, s)
    x = torch.abs((u + 0.5 - centers) * inv)
    w = torch.clamp(1.0 - x, min=0.0)
    in_src = ((u >= 0.0) & (u <= src - 1.0)).float()
    w = w * in_src
    col_ok = ((off + torch.arange(out_len, device=dev)[None, None, :]) < dst_true[:, None, None])
    col_ok = col_ok.float()
    w = w * col_ok
    total = w.sum(dim=1, keepdim=True)
    nearest = torch.minimum(torch.clamp(torch.floor(centers), min=0.0), src - 1.0)
    onehot = (u == nearest).float() * col_ok
    safe = torch.where(total > 0.0, total, torch.ones_like(total))
    return torch.where(total > 0.0, w / safe, onehot)


def _blur7(x: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """Separable Gaussian blur of (B, H, W, C) with a kernel a sample:
    radius ``max(1, floor(3 sigma + 0.5))``, taps past it zero, clamp to
    edge, horizontal then vertical; sigma 0 is the identity."""
    dev = x.device
    sg = sigma.float()[:, None]
    r = torch.clamp(torch.floor(sg * 3.0 + 0.5), min=1.0)
    t = torch.arange(-3, 4, dtype=torch.float32, device=dev)[None, :]
    k = torch.exp(-0.5 * t * t / torch.clamp(sg * sg, min=1e-20))
    k = torch.where(torch.abs(t) <= r, k, torch.zeros_like(k))
    k = k / k.sum(dim=1, keepdim=True)
    k = torch.where(sg > 0.0, k, (t == 0.0).float().expand_as(k))  # (B, 7)
    for dim in (2, 1):  # width, then height
        n = x.shape[dim]
        idx = torch.clamp(torch.arange(-3, n + 3, device=dev), 0, n - 1)
        xp = x.index_select(dim, idx)
        out = 0
        for i in range(7):
            out = out + k[:, i, None, None, None] * xp.narrow(dim, i, n)
        x = out
    return x


def augment_images(images: torch.Tensor, geom: torch.Tensor, sigma: torch.Tensor, crop: int,
                   mean, std) -> torch.Tensor:
    """(B, SH, SW, 3) uint8 canvases, ``geom`` (B, 7) int32 [h, w, oh, ow,
    x1, y1, flip], ``sigma`` (B,) -> (B, crop, crop, 3) f32 normalized:
    the width product, the height product, ``(acc / 255 - mean) / std``
    as ``(acc * (1 / 255) - mean) * (1 / std)``, then the blur."""
    b, sh, sw, c = images.shape
    g = geom.long()
    h, w, oh, ow, x1, y1, flip = (g[:, i] for i in range(7))
    rw = resample_matrix(sw, crop, w, ow, x1, flip)  # (B, SW, crop)
    rh = resample_matrix(sh, crop, h, oh, y1)  # (B, SH, crop)
    with _no_tf32():
        # (B, SH x 3, SW) x (B, SW, crop): one product a sample, no broadcast copy of rw
        t = torch.bmm(images.float().permute(0, 1, 3, 2).reshape(b, sh * c, sw), rw)
        t = torch.bmm(rh.transpose(1, 2), t.view(b, sh, c * crop))  # (B, crop, 3 crop)
    t = t.reshape(b, crop, c, crop).permute(0, 1, 3, 2)
    mean = torch.tensor(mean, dtype=torch.float32, device=images.device)
    inv_std = 1.0 / torch.tensor(std, dtype=torch.float32, device=images.device)
    out = (t * torch.tensor(1.0 / 255.0, dtype=torch.float32) - mean) * inv_std
    return _blur7(out, sigma)


def augment_masks(masks: torch.Tensor, row_sel: torch.Tensor, col_sel: torch.Tensor,
                  pad_label: int) -> torch.Tensor:
    """(B, SH, SW) class-mapped masks -> (B, crop, crop) int32: whole rows
    ``row_sel``, then whole columns ``col_sel``, ``pad_label`` where
    either is -1."""
    b, _, sw = masks.shape
    rs, cs = row_sel.long(), col_sel.long()
    crop_h, crop_w = rs.shape[1], cs.shape[1]
    rows = torch.gather(masks.int(), 1, rs.clamp(min=0)[:, :, None].expand(b, crop_h, sw))
    out = torch.gather(rows, 2, cs.clamp(min=0)[:, None, :].expand(b, crop_h, crop_w))
    pad = (rs[:, :, None] < 0) | (cs[:, None, :] < 0)
    return torch.where(pad, torch.full_like(out, pad_label), out)


class DeviceAugment:
    """The crop, normalization and mask pad of the train augmentation on
    the device; ``apply`` takes a batch dict of ``DeviceInput`` items."""

    def __init__(self, crop: int, mean, std, pad_label: int):
        self.crop = int(crop)
        self.mean = tuple(float(m) for m in mean)
        self.std = tuple(float(s) for s in std)
        self.pad_label = int(pad_label)

    def apply(self, batch: dict):
        """batch dict -> (images f32 (B, crop, crop, 3), masks int32
        (B, crop, crop))."""
        images = augment_images(batch["image"], batch["aug_geom"], batch["aug_sigma"],
                                self.crop, self.mean, self.std)
        masks = augment_masks(batch["mask"], batch["row_sel"], batch["col_sel"], self.pad_label)
        return images, masks
