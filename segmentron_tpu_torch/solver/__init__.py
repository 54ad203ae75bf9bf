"""Losses, LR schedules and the optimizer (counterpart of
``segmentron_tpu/solver``)."""

from .loss import get_segmentation_loss
from .lr_scheduler import get_lr_scheduler, warmup_cosine_lr, warmup_poly_lr, warmup_step_lr
from .optimizer import get_optimizer

__all__ = [
    "get_lr_scheduler",
    "get_optimizer",
    "get_segmentation_loss",
    "warmup_cosine_lr",
    "warmup_poly_lr",
    "warmup_step_lr",
]
