"""Pooling (counterpart of ``segmentron_tpu/ops/pool.py``)."""

from __future__ import annotations

import torch

__all__ = ["global_avg_pool"]


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """Mean over H, W of an NCHW tensor, kept as (N, C, 1, 1); summed in
    f32 and cast back (ASPP image pooling)."""
    return x.float().mean(dim=(2, 3), keepdim=True).to(x.dtype)
