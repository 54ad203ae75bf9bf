"""Segmentation losses (counterpart of ``segmentron_tpu/solver/loss.py``).

Each loss takes the model's tuple of NHWC logit maps and an integer
target (N, H, W) whose ignored pixels are -1, and returns an f32 scalar.
Means are over the valid pixels with the count clamped to 1, so an
all-ignore batch gives 0, not NaN (torch's own ``ignore_index`` default
is -100 and its mean is NaN there).

``get_segmentation_loss`` dispatches in the JAX package's order. Of its
losses, mixed CE (+ aux), OHEM CE and the per-output weighted CE
(``MODEL.MULTI_LOSS_WEIGHT``) are ported; the model-specific losses
(ICNet, EncNet, PointRend, TransLab) and focal, lovasz and dice raise
``NotImplementedError``.
"""

from __future__ import annotations

import functools
from typing import Callable, Sequence

import torch
import torch.nn.functional as F

__all__ = [
    "cross_entropy",
    "get_segmentation_loss",
    "mix_softmax_ce_loss",
    "multi_weight_loss",
    "ohem_ce_loss",
]


def _flatten(logits, target):
    return logits.reshape(-1, logits.shape[-1]).float(), target.reshape(-1).long()


def cross_entropy(logits, target):
    """Mean CE over the valid (target >= 0) pixels, in f32."""
    lf, tf = _flatten(logits, target)
    total = F.cross_entropy(lf, tf, ignore_index=-1, reduction="sum")
    return total / (tf >= 0).sum().clamp(min=1)


def mix_softmax_ce_loss(outputs: Sequence, target, aux_weight: float = 0.4):
    """Main CE + ``aux_weight`` x CE of each aux output."""
    loss = cross_entropy(outputs[0], target)
    for aux in outputs[1:]:
        loss = loss + aux_weight * cross_entropy(aux, target)
    return loss


def _ohem_single(logits, target, thresh: float, min_kept: int):
    lf, tf = _flatten(logits, target)
    valid = tf >= 0
    logp_t = torch.log_softmax(lf, dim=-1).gather(1, tf.clamp(min=0)[:, None])[:, 0]
    with torch.no_grad():
        p_t = torch.where(valid, logp_t.exp(), torch.full_like(logp_t, float("inf")))
        # the cutoff rises to the min_kept-th smallest prob when fewer
        # than min_kept pixels fall below thresh
        k = min(min_kept, p_t.numel())
        cutoff = torch.tensor(thresh, device=p_t.device)
        if k > 0:
            kth = torch.topk(p_t, k, largest=False).values[-1]
            cutoff = torch.maximum(kth, cutoff)
        keep = valid & (p_t <= cutoff)
    nll = torch.where(keep, -logp_t, torch.zeros_like(logp_t))
    return nll.sum() / keep.sum().clamp(min=1)


def ohem_ce_loss(outputs: Sequence, target, aux_weight: float = 0.4, thresh: float = 0.7,
                 min_kept: int = 100_000):
    """Online hard example mining CE: the valid pixels whose true-class
    probability is <= ``thresh``, and at least the ``min_kept`` hardest;
    aux outputs weighted by ``aux_weight``."""
    loss = _ohem_single(outputs[0], target, thresh, min_kept)
    for aux in outputs[1:]:
        loss = loss + aux_weight * _ohem_single(aux, target, thresh, min_kept)
    return loss


def multi_weight_loss(outputs: Sequence, target, weights: Sequence[float]):
    """Per-output weighted CE (DANet's ``MULTI_LOSS_WEIGHT``); outputs
    past the list take its last weight."""
    loss = 0.0
    for i, out in enumerate(outputs):
        w = weights[i] if i < len(weights) else weights[-1]
        loss = loss + w * cross_entropy(out, target)
    return loss


def _not_ported(name: str) -> None:
    raise NotImplementedError(f"the {name} loss is not ported to PyTorch yet")


def get_segmentation_loss(model_name: str = "", **kwargs) -> Callable:
    """``loss_fn(outputs, target) -> scalar``. kwargs as in the JAX
    package: use_ohem, aux_weight, loss_name, ohem_thresh, ohem_min_kept,
    multi_loss_weight (aux and se_weight are accepted and not read, as
    there)."""
    aux_weight = kwargs.get("aux_weight", 0.4)
    loss_name = (kwargs.get("loss_name") or "").lower()
    mlw = kwargs.get("multi_loss_weight") or [1.0]
    model = (model_name or "").lower()

    if model in ("icnet", "pointrend", "translab", "encnet"):
        _not_ported(model)
    if kwargs.get("use_ohem", False):
        return functools.partial(
            ohem_ce_loss, aux_weight=aux_weight, thresh=kwargs.get("ohem_thresh", 0.7),
            min_kept=kwargs.get("ohem_min_kept", 100_000),
        )
    if loss_name in ("focal", "lovasz", "dice", "binary_dice"):
        _not_ported(loss_name)
    if len(mlw) > 1:
        return functools.partial(multi_weight_loss, weights=list(mlw))
    return functools.partial(mix_softmax_ce_loss, aux_weight=aux_weight)
