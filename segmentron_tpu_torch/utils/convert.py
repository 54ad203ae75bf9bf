"""Weight bridge: the JAX package's flax variables -> this port's
``state_dict``.

The port names its modules after the flax scopes, so the mapping is
mechanical: the scope path joined with dots, and per leaf

- conv ``kernel`` HWIO -> ``weight`` OIHW (a depthwise ``(3,3,1,C)``
  becomes ``(C,1,3,3)``); a conv ``bias`` stays ``bias``;
- BN ``scale``/``bias`` -> ``weight``/``bias`` and ``batch_stats``
  ``mean``/``var`` -> ``running_mean``/``running_var``, plus a zero
  ``num_batches_tracked``;
- a scalar leaf (DANet's ``gamma``) -> a 0-d parameter of the same name.

It takes plain numpy (nested dicts), so converting needs no JAX; the
caller does the ``np.asarray`` over the flax tree.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

__all__ = ["from_flax_variables"]


def _walk(tree: Mapping, prefix=()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _walk(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def from_flax_variables(variables: Mapping) -> Dict[str, torch.Tensor]:
    """``{"params": ..., "batch_stats": ...}`` (nested dicts of numpy
    arrays) -> a ``state_dict`` for the port's model of the same
    configuration."""
    params = dict(_walk(variables["params"]))
    stats = dict(_walk(variables.get("batch_stats", {})))

    def leaf(tree, scope, key):
        return torch.from_numpy(np.array(tree[scope + (key,)], np.float32))

    state: Dict[str, torch.Tensor] = {}
    for path, value in params.items():
        if np.ndim(value) == 0:
            state[".".join(path)] = torch.tensor(float(value))
    for scope in sorted({path[:-1] for path in params if np.ndim(params[path]) > 0}):
        name = ".".join(scope)
        if scope + ("kernel",) in params:
            state[f"{name}.weight"] = leaf(params, scope, "kernel").permute(3, 2, 0, 1).contiguous()
            if scope + ("bias",) in params:
                state[f"{name}.bias"] = leaf(params, scope, "bias")
        elif scope + ("scale",) in params:
            state[f"{name}.weight"] = leaf(params, scope, "scale")
            state[f"{name}.bias"] = leaf(params, scope, "bias")
            state[f"{name}.running_mean"] = leaf(stats, scope, "mean")
            state[f"{name}.running_var"] = leaf(stats, scope, "var")
            state[f"{name}.num_batches_tracked"] = torch.zeros((), dtype=torch.long)
        else:
            raise KeyError(f"unrecognised flax scope {'/'.join(scope)}: "
                           f"{sorted(k[-1] for k in params if k[:-1] == scope)}")
    return state
