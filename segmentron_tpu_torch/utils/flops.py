"""Parameter and FLOPs report (counterpart of
``segmentron_tpu/utils/flops.py::show_flops_params``).

The forward's FLOPs come from ``torch.utils.flop_counter.FlopCounterMode``
over a copy of the model on the meta device in eval mode, with the
fused entry off (the copy computes the same convolutions through the
plain modules), so counting runs nothing on the card. Best-effort, as
in the JAX package: when counting fails the report has no FLOPs.
"""

from __future__ import annotations

import copy
from typing import Optional, Sequence

import torch

__all__ = ["count_params", "model_flops", "show_flops_params"]


def count_params(model: torch.nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def model_flops(model: torch.nn.Module, input_shape: Sequence[int]) -> Optional[float]:
    """Forward FLOPs of one batch of NHWC ``input_shape`` (a multiply-add
    counts two)."""
    from torch.utils.flop_counter import FlopCounterMode

    try:
        meta = copy.deepcopy(model).to("meta").eval()
        for m in meta.modules():
            if hasattr(m, "fused_stem"):
                m.fused_stem = False
        x = torch.zeros(tuple(input_shape), device="meta")
        with FlopCounterMode(display=False) as counter, torch.no_grad():
            meta(x)
        return float(counter.get_total_flops()) or None
    except (RuntimeError, NotImplementedError, ValueError, TypeError):
        return None


def show_flops_params(model: torch.nn.Module, input_shape: Sequence[int], logger) -> None:
    n_params = count_params(model)
    flops = model_flops(model, input_shape)
    if flops:
        logger.info("Model params: %.2fM, forward FLOPs @%s: %.2fG", n_params / 1e6,
                    "x".join(map(str, input_shape[1:3])), flops / 1e9)
    else:
        logger.info("Model params: %.2fM (FLOPs analysis unavailable)", n_params / 1e6)
