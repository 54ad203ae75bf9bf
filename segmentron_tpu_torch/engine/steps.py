"""Train, eval and inference steps (counterpart of
``segmentron_tpu/engine/steps.py``: ``make_train_step``,
``make_eval_step``, ``make_predict_fn``)."""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch
import torch.nn as nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..config import cfg
from ..modules import Dropout2d, running_stats_frozen
from ..ops import maybe_normalize
from ..utils import confusion_matrix_update, resolve_device

__all__ = ["REMAT_MODES", "make_eval_step", "make_predict_fn", "make_train_step"]

REMAT_MODES = ("none", "dots", "full")
# the products whose outputs TPU.REMAT "dots" keeps for the backward
SAVED_BY_DOTS = (torch.ops.aten.convolution.default, torch.ops.aten.mm.default,
                 torch.ops.aten.addmm.default, torch.ops.aten.bmm.default)

_NORMS = (nn.BatchNorm2d, nn.GroupNorm)


def _as_dtype(dtype: Union[str, torch.dtype, None]) -> torch.dtype:
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        return dtype
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[str(dtype)]


def _norm_param_names(model: nn.Module) -> set:
    """Names of the norm layers' parameters, which a bf16 step rounds to
    bf16 and keeps in f32 storage."""
    return {f"{name}.{p}" for name, m in model.named_modules() if isinstance(m, _NORMS)
            for p, _ in m.named_parameters(recurse=False)}


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


def _dots_policy(ctx, op, *args, **kwargs):
    """TPU.REMAT "dots": keep the products' outputs, recompute the rest."""
    if op in SAVED_BY_DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


class _Recompute:
    """The recompute side of a rematerialized forward: the dropout
    generator set back to its state when the forward began (restored to
    its current state after), the BN running statistics frozen, and the
    selective policy's own context where there is one.
    ``torch.utils.checkpoint`` restores only the default generators, so
    without this the recomputed dropout masks would differ from the
    forward's and the gradients would be wrong with no error."""

    def __init__(self, generator: torch.Generator, inner):
        self.generator = generator
        self.start = generator.get_state()
        self.inner = inner
        self.stack = None

    def __enter__(self):
        self.stack = contextlib.ExitStack()
        now = self.generator.get_state()
        self.generator.set_state(self.start)
        self.stack.callback(self.generator.set_state, now)
        self.stack.enter_context(running_stats_frozen())
        self.stack.enter_context(self.inner)
        return self

    def __exit__(self, *exc):
        return self.stack.__exit__(*exc)


class TrainStep:
    """One SGD update of the model a call; see ``make_train_step``.
    ``updates`` counts the updates made (the schedule's step, restored on
    resume); ``generator`` draws the dropout masks."""

    def __init__(self, model, loss_fn, optimizer, lr_schedule, dtype, remat, device,
                 generator, augment):
        self.model, self.loss_fn, self.optimizer = model, loss_fn, optimizer
        self.lr_schedule, self.dtype, self.remat = lr_schedule, dtype, remat
        self.device, self.generator, self.augment = device, generator, augment
        self.updates = 0
        self.mean, self.std = list(cfg.DATASET.MEAN), list(cfg.DATASET.STD)
        self.params = dict(model.named_parameters())
        self.norm_params = _norm_param_names(model)

    def _context_fn(self):
        if self.remat == "full":
            forward, recompute = contextlib.nullcontext(), contextlib.nullcontext()
        else:
            forward, recompute = create_selective_checkpoint_contexts(_dots_policy)
        return forward, _Recompute(self.generator, recompute)

    def forward(self, x):
        """The model's outputs on ``x``: on bf16 copies of the f32 masters
        for a bf16 step (cast outside the rematerialized part, as the JAX
        package casts before ``jax.checkpoint``), under
        ``torch.utils.checkpoint`` for TPU.REMAT "dots" and "full"."""
        if self.dtype == torch.float32:
            run = self.model
        else:
            cast = {name: p.to(self.dtype).float() if name in self.norm_params
                    else p.to(self.dtype) for name, p in self.params.items()}

            def run(inp):
                return torch.func.functional_call(self.model, cast, (inp,))
        if self.remat == "none":
            return run(x)
        return checkpoint(run, x, use_reentrant=False, context_fn=self._context_fn)

    def __call__(self, *batch) -> torch.Tensor:
        if self.augment is not None:
            (feed,) = batch
            feed = {k: v.to(self.device) for k, v in feed.items() if k != "name"}
            images, masks = self.augment.apply(feed)
        else:
            images, masks = (torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                             for a in batch)
            images = maybe_normalize(images.to(self.device), self.mean, self.std)
        x = images.to(self.dtype)
        target = masks.to(self.device).long()
        lr = float(self.lr_schedule(self.updates))
        for group in self.optimizer.param_groups:
            group["lr"] = lr * group.get("lr_factor", 1.0)
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.loss_fn(self.forward(x), target)
        loss.backward()
        self.optimizer.step()
        self.updates += 1
        return loss.detach()


def make_train_step(model: nn.Module, loss_fn: Callable, optimizer: torch.optim.Optimizer,
                    lr_schedule: Callable, compute_dtype=None, remat: Optional[str] = None,
                    device=None, generator: Optional[torch.Generator] = None,
                    augment=None) -> TrainStep:
    """``step(images, masks) -> loss``: one SGD update of ``model`` on a
    batch, as the JAX package's train step does it on one device.

    ``images``: NHWC uint8 (normalized on the device with
    ``cfg.DATASET.MEAN/STD``) or normalized floats; ``masks``: (N, H, W)
    integer class ids, ignore = -1; numpy or tensors. With ``augment``
    (an ``ops/preprocess.py::DeviceAugment``) the step takes one batch
    dict of ``data/device_input.py`` items instead and runs the train
    augmentation on the device before the forward. The loss comes back as
    an f32 0-d tensor on the device (no host sync).

    Moves ``model`` to ``device`` (default CUDA; raises when there is
    none) in ``channels_last`` memory and ``.train()`` mode. Before each
    update the optimizer's group LRs are set to ``lr_schedule(k) *
    lr_factor`` for update k = ``step.updates`` (0, 1, ...).
    ``generator`` (default: seeded with ``cfg.SEED`` on the device) draws
    every ``Dropout2d`` mask.

    ``compute_dtype`` bfloat16 is the JAX package's mixed precision, a
    cast and not autocast: the parameters stay f32 masters, every float
    parameter is cast to bf16 for the step (norm affines rounded to bf16
    and kept in f32 storage, as ``make_predict_fn`` does) and the model
    runs through ``torch.func.functional_call`` on those copies, so the
    gradients come back through the casts as f32; the buffers (BN
    statistics) pass as they are and stay f32; the input is cast to
    bf16; the loss is computed in f32.

    ``remat`` (default ``cfg.TPU.REMAT``): "none" keeps every activation;
    "full" runs the forward under ``torch.utils.checkpoint`` (non-
    reentrant), keeping its inputs and recomputing all of it in the
    backward; "dots" keeps the outputs of the products (``aten``
    convolution, mm, addmm, bmm) by a selective checkpoint policy and
    recomputes the rest. "dots" is the counterpart of the JAX package's
    ``dots_with_no_batch_dims_saveable``, with one difference: XLA's
    policy counts no convolution as a dot, so there the convolutions'
    outputs are recomputed and here they are kept. The bf16 copies of
    the parameters are made outside the checkpointed forward, as the JAX
    package casts before ``jax.checkpoint``: they are kept for the
    backward in every mode. The recompute draws the forward's dropout
    masks again and leaves the BN running statistics alone (``_Recompute``),
    so each mode takes the same step. Other modes raise ``ValueError``."""
    remat = str(cfg.TPU.REMAT) if remat is None else remat
    if remat not in REMAT_MODES:
        raise ValueError(f"Unknown remat mode: {remat!r}")
    device = resolve_device(device)
    dtype = _as_dtype(compute_dtype)
    model.train().to(device, memory_format=torch.channels_last)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(int(cfg.SEED))
    for m in model.modules():
        if isinstance(m, Dropout2d):
            m.generator = generator
    return TrainStep(model, loss_fn, optimizer, lr_schedule, dtype, remat, device, generator,
                     augment)


def make_eval_step(model: nn.Module, nclass: int, compute_dtype=None, device=None) -> Callable:
    """``eval_step(images, masks) -> cm``: the (nclass, nclass) int64
    confusion matrix of a batch, computed on the device (argmax of the
    main output, ``confusion_matrix_update``), as the JAX package's
    ``make_eval_step`` on one device. ``images`` NHWC uint8 or normalized
    floats, ``masks`` class ids with ignore = -1; numpy or tensors.

    The model runs in eval mode for the call (its mode is restored after)
    and on ``device`` (default CUDA; raises when there is none). For a
    bf16 ``compute_dtype`` it runs on bf16 copies of the f32 parameters
    (norm affines rounded and kept in f32), made once and refreshed in
    place each call, so the masters stay f32 and a kernel's cached packed
    weights see the refresh (their tensors' version counters move)."""
    device = resolve_device(device)
    dtype = _as_dtype(compute_dtype)
    mean, std = list(cfg.DATASET.MEAN), list(cfg.DATASET.STD)
    copies: Dict[str, torch.Tensor] = {}
    norm_params = _norm_param_names(model)

    @torch.no_grad()
    def eval_step(images, masks) -> torch.Tensor:
        if isinstance(images, np.ndarray):
            images = torch.from_numpy(images)
        if isinstance(masks, np.ndarray):
            masks = torch.from_numpy(masks)
        x = maybe_normalize(images.to(device), mean, std).to(dtype)
        was_training = model.training
        model.eval()
        try:
            if dtype == torch.float32:
                outputs = model(x)
            else:
                for name, p in model.named_parameters():
                    if name not in copies:
                        copies[name] = torch.empty_like(
                            p, dtype=torch.float32 if name in norm_params else dtype)
                    if name in norm_params:
                        copies[name].copy_(p.to(dtype))
                    else:
                        copies[name].copy_(p)
                outputs = torch.func.functional_call(model, copies, (x,))
        finally:
            model.train(was_training)
        pred = outputs[0].argmax(dim=-1)
        return confusion_matrix_update(pred, masks.to(device), nclass)

    return eval_step
