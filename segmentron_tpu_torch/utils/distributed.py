"""One-process counterparts of ``segmentron_tpu/utils/distributed.py``'s
rank helpers and its sampler. Data parallelism across processes (DDP,
SyncBN across cards) is not ported: ``default_setup`` refuses a
multi-process launch."""

from __future__ import annotations

import numpy as np

__all__ = ["get_rank", "get_world_size", "is_main_process", "make_data_sampler"]


def get_world_size() -> int:
    return 1


def get_rank() -> int:
    return 0


def is_main_process() -> bool:
    return True


def make_data_sampler(num_examples: int, shuffle: bool, seed: int, epoch: int) -> np.ndarray:
    """The epoch's order of the examples: a permutation drawn from
    ``np.random.RandomState(seed + epoch)``, or ``arange`` without
    shuffling; a pure function of its arguments, element for element
    the JAX package's order on one process."""
    if not shuffle:
        return np.arange(num_examples)
    return np.random.RandomState(seed + epoch).permutation(num_examples)
