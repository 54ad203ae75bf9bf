"""yacs-style hierarchical configuration (counterpart of
``segmentron_tpu/config/config.py``, kept as its own copy).

A nested attribute-access dict with YAML overlay (``update_from_file``),
CLI ``KEY VALUE`` overrides (``update_from_list``) and freeze-after-setup
semantics. The repository's ``configs/*.yaml`` load unchanged.
"""

from __future__ import annotations

import copy
import io
from typing import Any, Dict, List

import yaml

__all__ = ["SegmentronConfig"]


class SegmentronConfig(dict):
    """A dict with attribute access, recursive merge and freezing.

    Models read the config once at construction time and keep what they
    need as plain attributes; nothing reads it inside a forward pass.
    """

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        super().__init__()
        object.__setattr__(self, "_frozen", False)
        init = dict(*args, **kwargs)
        for k, v in init.items():
            self[k] = self._wrap(v)

    # -- attribute <-> item access -------------------------------------
    @classmethod
    def _wrap(cls, value: Any) -> Any:
        if isinstance(value, dict) and not isinstance(value, SegmentronConfig):
            return cls(value)
        if isinstance(value, (list, tuple)):
            return type(value)(cls._wrap(v) for v in value)
        return value

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None

    def __setattr__(self, name: str, value: Any) -> None:
        if name.startswith("_"):
            object.__setattr__(self, name, value)
            return
        self[name] = self._wrap(value)

    def __setitem__(self, key: str, value: Any) -> None:
        if getattr(self, "_frozen", False):
            raise AttributeError(
                f"SegmentronConfig is frozen; cannot set {key!r}"
            )
        super().__setitem__(key, self._wrap(value))

    def __delattr__(self, name: str) -> None:
        if getattr(self, "_frozen", False):
            raise AttributeError("SegmentronConfig is frozen")
        del self[name]

    # -- freeze ----------------------------------------------------------
    def freeze(self) -> "SegmentronConfig":
        object.__setattr__(self, "_frozen", True)
        for v in self.values():
            if isinstance(v, SegmentronConfig):
                v.freeze()
        return self

    def defrost(self) -> "SegmentronConfig":
        object.__setattr__(self, "_frozen", False)
        for v in self.values():
            if isinstance(v, SegmentronConfig):
                v.defrost()
        return self

    @property
    def is_frozen(self) -> bool:
        return getattr(self, "_frozen", False)

    # -- merging ---------------------------------------------------------
    def _merge(self, other: Dict[str, Any], path: str = "") -> None:
        for key, value in other.items():
            full = f"{path}.{key}" if path else key
            if key not in self:
                raise KeyError(f"Unknown config key: {full}")
            current = self[key]
            if isinstance(current, SegmentronConfig):
                if not isinstance(value, dict):
                    raise TypeError(
                        f"Config key {full} expects a mapping, got {type(value).__name__}"
                    )
                current._merge(value, full)
            else:
                super().__setitem__(key, self._coerce(current, value, full))

    @staticmethod
    def _coerce(current: Any, value: Any, key: str) -> Any:
        """Coerce an override to the default's type where unambiguous."""
        if current is None or value is None:
            return SegmentronConfig._wrap(value)
        if isinstance(current, bool) and not isinstance(value, bool):
            if isinstance(value, str):
                lowered = value.lower()
                if lowered in ("true", "1", "yes"):
                    return True
                if lowered in ("false", "0", "no", "none"):
                    return False
                if lowered in ("pw", "full", "stem", "block1"):
                    # tri-state knobs (TPU.INT8_ACTIVATIONS,
                    # TPU.FUSED_STEM): bool default, mode-string
                    # overrides from CLI/YAML
                    return lowered
            if isinstance(value, int):
                return bool(value)
            raise TypeError(f"Cannot coerce {value!r} to bool for key {key}")
        if isinstance(current, float) and isinstance(value, int):
            return float(value)
        if isinstance(current, (list, tuple)):
            if isinstance(value, str):  # CLI form: "[0.75, 1.0]"
                value = yaml.safe_load(io.StringIO(value))
            if not isinstance(value, (list, tuple)):
                raise TypeError(f"Cannot coerce {value!r} to list for key {key}")
            return SegmentronConfig._wrap(type(current)(value))
        if isinstance(current, (int, float, str)) and isinstance(value, str):
            # CLI opts arrive as strings; parse with YAML for safety.
            parsed = yaml.safe_load(io.StringIO(value))
            if isinstance(current, float) and isinstance(parsed, int):
                parsed = float(parsed)
            if current in ("pw", "full", "stem", "block1"):
                # tri-state knob already holding a mode string: keep the
                # same off-spellings working in either order ("0" yaml-
                # parses to int 0, bools to bool — normalize all to False)
                if isinstance(parsed, str) and parsed.lower() in (
                    "false", "0", "no", "none",
                ):
                    return False
                if isinstance(parsed, (bool, int)) and not parsed:
                    return False
            return parsed
        return SegmentronConfig._wrap(value)

    def update_from_file(self, config_file: str) -> "SegmentronConfig":
        """Overlay a YAML file (same schema as the reference's configs/)."""
        with open(config_file, "r") as f:
            loaded = yaml.safe_load(f) or {}
        was_frozen = self.is_frozen
        if was_frozen:
            self.defrost()
        self._merge(loaded)
        if was_frozen:
            self.freeze()
        return self

    def update_from_list(self, opts: List[Any]) -> "SegmentronConfig":
        """Overlay dotted KEY VALUE pairs, e.g. ['SOLVER.LR', '0.02']."""
        if not opts:
            return self
        if len(opts) % 2 != 0:
            raise ValueError(f"opts must be KEY VALUE pairs, got {opts}")
        was_frozen = self.is_frozen
        if was_frozen:
            self.defrost()
        for key, value in zip(opts[0::2], opts[1::2]):
            node: Any = self
            parts = key.split(".")
            for part in parts[:-1]:
                if part not in node:
                    raise KeyError(f"Unknown config key: {key}")
                node = node[part]
            leaf = parts[-1]
            if leaf not in node:
                raise KeyError(f"Unknown config key: {key}")
            dict.__setitem__(node, leaf, self._coerce(node[leaf], value, key))
        if was_frozen:
            self.freeze()
        return self

    # -- misc --------------------------------------------------------------
    def clone(self) -> "SegmentronConfig":
        return SegmentronConfig(self.to_dict())

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for k, v in self.items():
            if isinstance(v, SegmentronConfig):
                out[k] = v.to_dict()
            elif isinstance(v, (list, tuple)):
                out[k] = [
                    x.to_dict() if isinstance(x, SegmentronConfig) else x for x in v
                ]
            else:
                out[k] = v
        return out

    def dump(self) -> str:
        return yaml.safe_dump(self.to_dict(), default_flow_style=None)

    def __deepcopy__(self, memo: Dict[int, Any]) -> "SegmentronConfig":
        return SegmentronConfig(copy.deepcopy(self.to_dict(), memo))

    def __repr__(self) -> str:
        return f"SegmentronConfig({dict.__repr__(self)})"
