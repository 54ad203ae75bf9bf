"""Batch loader with prefetch to the device (counterpart of
``segmentron_tpu/data/loader.py::DataLoader``).

Worker threads (``num_workers``) decode and transform the items (PIL and
numpy release the GIL for the heavy parts); a batch is stacked into
numpy arrays, wrapped as pinned host tensors and copied to the device
with ``non_blocking=True``, ``prefetch`` batches ahead of the consumer.
On the CPU device the tensors stay where they are.
"""

from __future__ import annotations

import collections
import concurrent.futures as cf
from typing import Iterator, Optional

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.distributed import make_data_sampler

__all__ = ["DataLoader"]


class DataLoader:
    """Batches of ``dataset`` as dicts: ``image`` (uint8 or f32 NHWC),
    ``mask`` (int32) where the items have one, ``name`` (a list), or in
    device-augment mode the keys of ``DeviceInput.build_train_item``.
    ``drop_last`` defaults to ``shuffle``. ``device`` defaults to CUDA
    (raises when there is none)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False, seed: int = 0,
                 drop_last: Optional[bool] = None, num_workers: int = 4, prefetch: int = 2,
                 device=None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last if drop_last is not None else shuffle
        self.num_workers = max(1, num_workers)
        self.prefetch = max(0, prefetch)
        self.device = resolve_device(device)
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)  # advances the per-sample augmentation stream

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _batches(self, pool) -> Iterator[dict]:
        order = make_data_sampler(len(self.dataset), self.shuffle, self.seed, self.epoch)
        if self.drop_last:
            order = order[: len(order) - len(order) % self.batch_size]
        for start in range(0, len(order), self.batch_size):
            idxs = order[start: start + self.batch_size]
            items = list(pool.map(self.dataset.__getitem__, idxs))
            if isinstance(items[0][0], dict):
                # device-augment items: stack every key (uint8 canvas, int16
                # mask, the augmentation's draws)
                batch = {k: np.stack([it[0][k] for it in items]) for k in items[0][0]}
            else:
                images = np.stack([it[0] for it in items])
                if images.dtype != np.uint8:
                    images = images.astype(np.float32)
                batch = {"image": images}
                if items[0][1] is not None:
                    batch["mask"] = np.stack([it[1] for it in items]).astype(np.int32)
            batch["name"] = [it[2] for it in items]
            yield batch

    def __iter__(self) -> Iterator[dict]:
        with cf.ThreadPoolExecutor(self.num_workers) as pool:
            queue = collections.deque()
            for batch in self._batches(pool):
                queue.append(self._to_device(batch))
                if len(queue) > self.prefetch:
                    yield queue.popleft()
            while queue:
                yield queue.popleft()

    def _to_device(self, batch: dict) -> dict:
        names = batch.pop("name")
        pin = self.device.type == "cuda"
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            out[k] = t.pin_memory().to(self.device, non_blocking=True) if pin else t
        out["name"] = names
        return out
