"""Snapshots and the best model (counterpart of
``segmentron_tpu/utils/checkpoint.py::CheckpointManager``).

A snapshot is one ``torch.save`` file, ``<directory>/step_<N>.pt``, of
a dict of tensors and plain values (``Trainer.state_dict``: the step,
the model's ``state_dict`` with its BN buffers, the optimizer's
``state_dict``, the dropout generator's state and the run's seed),
read back with ``torch.load(weights_only=True)``. The newest
``max_to_keep`` snapshots are kept. The best model lives in the sibling
``<directory>_best`` (one file, never rotated out by the snapshots) with
``best_meta.json`` holding its step and mIoU. Each file is written to a
temporary name in its directory and moved into place with
``os.replace``, so a reader never sees half a file. Writes are
synchronous: ``wait`` and ``close`` have nothing to do.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
from typing import Any, Dict, List, Optional

import torch

__all__ = ["CheckpointManager"]

_STEP_FILE = re.compile(r"^step_(\d+)\.pt$")


def _atomic_write(path: str, write) -> None:
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), prefix=".tmp_")
    try:
        with os.fdopen(fd, "wb") as f:
            write(f)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 5):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    # ------------------------------------------------------ best model
    @property
    def best_directory(self) -> str:
        return self.directory.rstrip("/") + "_best"

    def _best_meta_path(self) -> str:
        return os.path.join(self.best_directory, "best_meta.json")

    def best_meta(self) -> Optional[dict]:
        """``{"step": int, "miou": float}`` of the saved best, or None."""
        try:
            with open(self._best_meta_path()) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def save_best(self, step: int, state: Dict[str, Any], miou: float) -> None:
        """Save ``state`` as the best model (replacing the previous one),
        then its ``best_meta.json``."""
        os.makedirs(self.best_directory, exist_ok=True)
        path = os.path.join(self.best_directory, f"step_{int(step)}.pt")
        _atomic_write(path, lambda f: torch.save(state, f))
        for old in self._steps(self.best_directory):
            if old != int(step):
                os.remove(os.path.join(self.best_directory, f"step_{old}.pt"))
        meta = json.dumps({"step": int(step), "miou": float(miou)}).encode()
        _atomic_write(self._best_meta_path(), lambda f: f.write(meta))

    def restore_best(self) -> Optional[Dict[str, Any]]:
        """The best model's saved state, or None where there is none."""
        steps = self._steps(self.best_directory)
        return self._load(self.best_directory, steps[-1]) if steps else None

    # ------------------------------------------------------- rotating
    @staticmethod
    def _steps(directory: str) -> List[int]:
        if not os.path.isdir(directory):
            return []
        return sorted(int(m.group(1)) for m in map(_STEP_FILE.match, os.listdir(directory)) if m)

    @staticmethod
    def _load(directory: str, step: int) -> Dict[str, Any]:
        return torch.load(os.path.join(directory, f"step_{step}.pt"), map_location="cpu",
                          weights_only=True)

    def all_steps(self) -> List[int]:
        return self._steps(self.directory)

    def save(self, step: int, state: Dict[str, Any]) -> None:
        """Save ``state`` as snapshot ``step`` (a step already saved is
        left as it is), then drop all but the newest ``max_to_keep``."""
        step = int(step)
        if step in self.all_steps():
            return
        _atomic_write(os.path.join(self.directory, f"step_{step}.pt"),
                      lambda f: torch.save(state, f))
        for old in self.all_steps()[:-self.max_to_keep]:
            os.remove(os.path.join(self.directory, f"step_{old}.pt"))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int) -> Dict[str, Any]:
        return self._load(self.directory, int(step))

    def restore_latest(self) -> Optional[Dict[str, Any]]:
        step = self.latest_step()
        return None if step is None else self.restore(step)

    def wait(self) -> None:
        """Saves are synchronous: nothing is in flight."""

    def close(self) -> None:
        """Nothing is held open."""
