"""Logging (counterpart of ``segmentron_tpu/utils/logger.py``): one
process, so every record goes to stdout and, given a directory, to a
file in it."""

from __future__ import annotations

import logging
import os
import sys
from typing import Optional

__all__ = ["get_logger", "setup_logger"]

_LOGGER_NAME = "segmentron_tpu_torch"


def setup_logger(name: str = _LOGGER_NAME, save_dir: Optional[str] = None,
                 filename: str = "log.txt", mode: str = "w") -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    logger.propagate = False
    for handler in list(logger.handlers):
        logger.removeHandler(handler)
        handler.close()
    fmt = logging.Formatter("%(asctime)s %(name)s %(levelname)s: %(message)s",
                            datefmt="%Y-%m-%d %H:%M:%S")
    stream = logging.StreamHandler(stream=sys.stdout)
    stream.setFormatter(fmt)
    logger.addHandler(stream)
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        file = logging.FileHandler(os.path.join(save_dir, filename), mode=mode)
        file.setFormatter(fmt)
        logger.addHandler(file)
    return logger


def get_logger(name: str = _LOGGER_NAME) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        setup_logger(name)
    return logger
