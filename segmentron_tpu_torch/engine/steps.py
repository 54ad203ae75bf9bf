"""Train and inference steps (counterpart of
``segmentron_tpu/engine/steps.py``: ``make_train_step``,
``make_predict_fn``)."""

from __future__ import annotations

from typing import Callable, Optional, Union

import numpy as np
import torch
import torch.nn as nn

from ..config import cfg
from ..modules import Dropout2d
from ..ops import maybe_normalize
from ..utils import resolve_device

__all__ = ["make_predict_fn", "make_train_step"]

_NORMS = (nn.BatchNorm2d, nn.GroupNorm)


def _as_dtype(dtype: Union[str, torch.dtype, None]) -> torch.dtype:
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        return dtype
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[str(dtype)]


@torch.no_grad()
def _cast_params(model: nn.Module, dtype: torch.dtype) -> None:
    """Cast the float parameters to ``dtype`` in place (the statistics
    stay f32, as the JAX package casts ``params`` and not
    ``batch_stats``). Norm affines are rounded to ``dtype`` but kept in
    f32 storage, so each norm reads one parameter dtype."""
    for module in model.modules():
        keep_f32 = isinstance(module, _NORMS)
        for p in module.parameters(recurse=False):
            p.data = p.data.to(dtype).float() if keep_f32 else p.data.to(dtype)


def make_predict_fn(model: nn.Module, compute_dtype=None, device=None) -> Callable:
    """``predict(images) -> logits``: NHWC images (uint8, normalized on
    the device with ``cfg.DATASET.MEAN/STD``, or already-normalized
    floats; numpy or tensor) -> the model's main output as f32 NHWC
    logits.

    Moves ``model`` to ``device`` (default CUDA; raises when there is
    none) and, for a compute dtype other than f32, casts its float
    parameters to that dtype in place."""
    device = resolve_device(device)
    dtype = _as_dtype(compute_dtype)
    model.eval().to(device, memory_format=torch.channels_last)
    if dtype != torch.float32:
        _cast_params(model, dtype)
    mean, std = list(cfg.DATASET.MEAN), list(cfg.DATASET.STD)

    @torch.inference_mode()
    def predict(images) -> torch.Tensor:
        if isinstance(images, np.ndarray):
            images = torch.from_numpy(images)
        x = maybe_normalize(images.to(device), mean, std).to(dtype)
        return model(x)[0].float()

    return predict


def make_train_step(model: nn.Module, loss_fn: Callable, optimizer: torch.optim.Optimizer,
                    lr_schedule: Callable, compute_dtype=None, remat: Optional[str] = None,
                    device=None, generator: Optional[torch.Generator] = None) -> Callable:
    """``step(images, masks) -> loss``: one SGD update of ``model`` on a
    batch, as the JAX package's train step does it on one device.

    ``images``: NHWC uint8 (normalized on the device with
    ``cfg.DATASET.MEAN/STD``) or normalized floats; ``masks``: (N, H, W)
    integer class ids, ignore = -1; numpy or tensors. The loss comes back
    as an f32 0-d tensor on the device (no host sync).

    Moves ``model`` to ``device`` (default CUDA; raises when there is
    none) in ``channels_last`` memory and ``.train()`` mode. Before each
    update the optimizer's group LRs are set to ``lr_schedule(k) *
    lr_factor`` for update k = 0, 1, ... ``generator`` (default: seeded
    with ``cfg.SEED`` on the device) draws every ``Dropout2d`` mask.

    ``compute_dtype`` bfloat16 is the JAX package's mixed precision, a
    cast and not autocast: the parameters stay f32 masters, every float
    parameter is cast to bf16 for the step (norm affines rounded to bf16
    and kept in f32 storage, as ``make_predict_fn`` does) and the model
    runs through ``torch.func.functional_call`` on those copies, so the
    gradients come back through the casts as f32; the buffers (BN
    statistics) pass as they are and stay f32; the input is cast to
    bf16; the loss is computed in f32.

    ``remat`` (default ``cfg.TPU.REMAT``): only "none" is ported; "dots"
    and "full" raise ``NotImplementedError``."""
    remat = str(cfg.TPU.REMAT) if remat is None else remat
    if remat != "none":
        raise NotImplementedError(f"remat={remat!r} (TPU.REMAT) is not ported to PyTorch yet")
    device = resolve_device(device)
    dtype = _as_dtype(compute_dtype)
    model.train().to(device, memory_format=torch.channels_last)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(int(cfg.SEED))
    for m in model.modules():
        if isinstance(m, Dropout2d):
            m.generator = generator
    mean, std = list(cfg.DATASET.MEAN), list(cfg.DATASET.STD)
    params = dict(model.named_parameters())
    norm_params = {f"{name}.{p}" for name, m in model.named_modules() if isinstance(m, _NORMS)
                   for p, _ in m.named_parameters(recurse=False)}
    updates = 0

    def forward(x):
        if dtype == torch.float32:
            return model(x)
        cast = {name: p.to(dtype).float() if name in norm_params else p.to(dtype)
                for name, p in params.items()}
        return torch.func.functional_call(model, cast, (x,))

    def step(images, masks) -> torch.Tensor:
        nonlocal updates
        if isinstance(images, np.ndarray):
            images = torch.from_numpy(images)
        if isinstance(masks, np.ndarray):
            masks = torch.from_numpy(masks)
        x = maybe_normalize(images.to(device), mean, std).to(dtype)
        target = masks.to(device).long()
        lr = float(lr_schedule(updates))
        for group in optimizer.param_groups:
            group["lr"] = lr * group.get("lr_factor", 1.0)
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(forward(x), target)
        loss.backward()
        optimizer.step()
        updates += 1
        return loss.detach()

    return step
