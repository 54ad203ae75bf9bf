"""Optimizer factory (counterpart of ``segmentron_tpu/solver/optimizer.py``).

Two parameter groups, as the JAX package labels its tree: the
parameters under the ``backbone`` scope train at the schedule's LR, all
others (decoder, heads) at LR x ``SOLVER.DECODER_LR_FACTOR``. SGD is
``torch.optim.SGD`` with coupled weight decay, no dampening and no
Nesterov (the JAX package's optax chain: ``grad += wd * p``; ``buf =
momentum * buf + grad``; ``p -= lr * buf``); Adam adds the decay to the
gradient before the moments, AdamW after them. The decay applies to
every parameter, BN affines and DANet's ``gamma`` included. Each group
carries its ``lr_factor``; the train step sets the groups' LRs from the
schedule before each update (step k uses ``schedule(k)``, from 0).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn as nn

__all__ = ["get_optimizer"]


def get_optimizer(cfg, model: nn.Module, schedule: Callable) -> torch.optim.Optimizer:
    name = cfg.SOLVER.OPTIMIZER.lower()
    wd = float(cfg.SOLVER.WEIGHT_DECAY)
    factor = float(cfg.SOLVER.DECODER_LR_FACTOR)
    backbone, decoder = [], []
    for pname, p in model.named_parameters():
        (backbone if "backbone" in pname.split(".") else decoder).append(p)
    lr0 = float(schedule(0))
    groups = [dict(params=ps, lr=lr0 * f, lr_factor=f)
              for ps, f in ((backbone, 1.0), (decoder, factor)) if ps]
    if name == "sgd":
        return torch.optim.SGD(groups, lr=lr0, momentum=float(cfg.SOLVER.MOMENTUM),
                               weight_decay=wd)
    if name in ("adam", "adamw"):
        cls = torch.optim.Adam if name == "adam" else torch.optim.AdamW
        return cls(groups, lr=lr0, eps=float(cfg.SOLVER.EPSILON), weight_decay=wd)
    raise ValueError(f"Unknown optimizer: {name}")
