"""LR schedules (counterpart of ``segmentron_tpu/solver/lr_scheduler.py``):
plain ``step -> lr`` functions, per iteration, with linear or constant
warmup:

    warmup:  lr = base * decay(step) * (factor + (1 - factor) * step / warmup)
    after:   lr = base * decay(step)
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

__all__ = ["get_lr_scheduler", "warmup_cosine_lr", "warmup_poly_lr", "warmup_step_lr"]


def _warmup_factor(step: float, warmup_iters: int, factor: float, method: str) -> float:
    if warmup_iters <= 0 or step >= warmup_iters:
        return 1.0
    if method == "constant":
        return factor
    alpha = min(max(step / warmup_iters, 0.0), 1.0)
    return factor * (1 - alpha) + alpha


def _clip01(x: float) -> float:
    return min(max(x, 0.0), 1.0)


def warmup_poly_lr(base_lr: float, max_iters: int, power: float = 0.9, warmup_iters: int = 0,
                   warmup_factor: float = 1.0 / 3, warmup_method: str = "linear") -> Callable:
    def schedule(step) -> float:
        step = float(step)
        poly = _clip01(1.0 - step / max(max_iters, 1)) ** power
        return base_lr * poly * _warmup_factor(step, warmup_iters, warmup_factor, warmup_method)

    return schedule


def warmup_cosine_lr(base_lr: float, max_iters: int, warmup_iters: int = 0,
                     warmup_factor: float = 1.0 / 3, warmup_method: str = "linear") -> Callable:
    def schedule(step) -> float:
        step = float(step)
        cos = 0.5 * (1.0 + math.cos(math.pi * _clip01(step / max(max_iters, 1))))
        return base_lr * cos * _warmup_factor(step, warmup_iters, warmup_factor, warmup_method)

    return schedule


def warmup_step_lr(base_lr: float, decay_steps: Sequence[int], gamma: float = 0.1,
                   warmup_iters: int = 0, warmup_factor: float = 1.0 / 3,
                   warmup_method: str = "linear") -> Callable:
    decay_steps = [float(s) for s in decay_steps]

    def schedule(step) -> float:
        step = float(step)
        n_decays = sum(step >= s for s in decay_steps)
        return (base_lr * gamma ** n_decays
                * _warmup_factor(step, warmup_iters, warmup_factor, warmup_method))

    return schedule


def get_lr_scheduler(cfg, iters_per_epoch: int) -> Callable:
    """The schedule ``cfg.SOLVER.LR_SCHEDULER`` names (poly | cosine |
    step), over ``TRAIN.EPOCHS * iters_per_epoch`` iterations."""
    max_iters = int(cfg.TRAIN.EPOCHS * iters_per_epoch)
    warmup = (int(cfg.SOLVER.WARMUP.EPOCHS * iters_per_epoch), float(cfg.SOLVER.WARMUP.FACTOR),
              cfg.SOLVER.WARMUP.METHOD)
    kind = cfg.SOLVER.LR_SCHEDULER.lower()
    lr = float(cfg.SOLVER.LR)
    if kind == "poly":
        return warmup_poly_lr(lr, max_iters, float(cfg.SOLVER.POLY.POWER), *warmup)
    if kind == "cosine":
        return warmup_cosine_lr(lr, max_iters, *warmup)
    if kind == "step":
        return warmup_step_lr(lr, [int(e * iters_per_epoch) for e in cfg.SOLVER.STEP.DECAY_EPOCH],
                              float(cfg.SOLVER.STEP.GAMMA), *warmup)
    raise ValueError(f"Unknown LR_SCHEDULER: {kind}")
