"""Run setup (counterpart of ``segmentron_tpu/utils/default_setup.py``):
the run name, its save and log directories, the logger, the seeds and
``config.yaml``, for one process."""

from __future__ import annotations

import os
import platform
import random
import sys

import numpy as np
import torch

from ..config import cfg
from .logger import setup_logger

__all__ = ["collect_env_info", "default_setup", "maybe_initialize_distributed", "seed_all_rng"]

_MULTI_PROCESS_ENV = ("JAX_COORDINATOR_ADDRESS", "MEGASCALE_COORDINATOR_ADDRESS")


def maybe_initialize_distributed() -> bool:
    """One process only. ``JAX_NUM_PROCESSES`` without
    ``JAX_COORDINATOR_ADDRESS`` raises ``RuntimeError`` (the JAX
    package's guard against a silent single-process run); any other
    multi-process launch (a coordinator address, or ``WORLD_SIZE`` > 1)
    raises ``NotImplementedError``, as DDP is not ported. Returns False
    (no process group)."""
    if os.environ.get("JAX_NUM_PROCESSES") and not os.environ.get("JAX_COORDINATOR_ADDRESS"):
        raise RuntimeError(
            "JAX_NUM_PROCESSES is set but JAX_COORDINATOR_ADDRESS is not: set both for a "
            "manual multi-process launch (or neither)")
    world = int(os.environ.get("WORLD_SIZE", "1") or 1)
    if world > 1 or any(os.environ.get(k) for k in _MULTI_PROCESS_ENV):
        raise NotImplementedError(
            "multi-process training (DDP, SyncBN across cards) is not ported to PyTorch yet")
    return False


def seed_all_rng(seed: int) -> int:
    """Seed Python's, numpy's and torch's global generators; returns
    ``seed``, from which the run seeds its own ``torch.Generator``s."""
    random.seed(seed)
    np.random.seed(seed % (2 ** 32))
    torch.manual_seed(seed)
    return int(seed)


def collect_env_info() -> str:
    cuda = torch.cuda.is_available()
    lines = [
        f"sys.platform: {sys.platform}",
        f"Python: {sys.version.replace(chr(10), ' ')}",
        f"numpy: {np.__version__}",
        f"torch: {torch.__version__} (CUDA {torch.version.cuda})",
        f"devices: {[torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())] if cuda else 'cpu only'}",
        f"platform: {platform.platform()}",
    ]
    return "\n".join(lines)


def default_setup(args=None) -> int:
    """Make the run's directories under ``cfg.ROOT_PATH`` (save and log
    dirs named ``<model>_<backbone>_<dataset>_<TIME_STAMP>``), write them
    into the cfg and freeze it, set up the logger with a file in the log
    dir, write ``config.yaml`` into the save dir, turn on anomaly
    detection for ``UTILS.DEBUG_NANS`` and seed every generator. Returns
    the run's seed (``cfg.SEED``)."""
    maybe_initialize_distributed()
    run_name = "_".join(x for x in (cfg.MODEL.MODEL_NAME.lower(), cfg.MODEL.BACKBONE.lower(),
                                     cfg.DATASET.NAME.lower(), cfg.TIME_STAMP) if x)
    save_dir = os.path.join(cfg.ROOT_PATH or ".", cfg.TRAIN.MODEL_SAVE_DIR, run_name)
    log_dir = os.path.join(cfg.ROOT_PATH or ".", cfg.TRAIN.LOG_SAVE_DIR, run_name)
    os.makedirs(save_dir, exist_ok=True)
    os.makedirs(log_dir, exist_ok=True)
    cfg.defrost()
    cfg.TRAIN.MODEL_SAVE_DIR = save_dir
    cfg.TRAIN.LOG_SAVE_DIR = log_dir
    cfg.freeze()

    logger = setup_logger(save_dir=log_dir, filename=f"{run_name}.txt")
    logger.info("Environment info:\n%s", collect_env_info())
    if args is not None:
        logger.info("Command line args: %s", args)
    logger.info("Running with config:\n%s", cfg.dump())
    with open(os.path.join(save_dir, "config.yaml"), "w") as f:
        f.write(cfg.dump())
    if cfg.UTILS.DEBUG_NANS:
        torch.autograd.set_detect_anomaly(True)
        logger.info("torch.autograd anomaly detection enabled")
    return seed_all_rng(int(cfg.SEED))
