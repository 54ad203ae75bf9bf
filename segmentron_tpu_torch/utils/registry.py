"""Name -> object registry (reference: ``segmentron/utils/registry.py::Registry``)."""

from __future__ import annotations

from typing import Any, Dict, Iterable, Optional

__all__ = ["Registry"]


class Registry:
    """String-keyed registry with a ``register`` decorator.

    Used for models, backbones, datasets and losses so that config
    strings (``cfg.MODEL.MODEL_NAME`` etc.) resolve to constructors.
    """

    def __init__(self, name: str) -> None:
        self._name = name
        self._obj_map: Dict[str, Any] = {}

    def _do_register(self, name: str, obj: Any) -> None:
        if name in self._obj_map:
            raise KeyError(
                f"An object named '{name}' was already registered in "
                f"'{self._name}' registry"
            )
        self._obj_map[name] = obj

    def register(self, obj: Any = None, *, name: Optional[str] = None) -> Any:
        if obj is None:
            # used as a decorator: @REGISTRY.register() / register(name=...)
            def deco(fn_or_class: Any) -> Any:
                self._do_register(name or fn_or_class.__name__, fn_or_class)
                return fn_or_class

            return deco
        self._do_register(name or obj.__name__, obj)
        return obj

    def get(self, name: str) -> Any:
        ret = self._obj_map.get(name)
        if ret is None:
            raise KeyError(
                f"No object named '{name}' found in '{self._name}' registry! "
                f"Available: {sorted(self._obj_map)}"
            )
        return ret

    def get_list(self) -> Iterable[str]:
        return list(self._obj_map.keys())

    def __contains__(self, name: str) -> bool:
        return name in self._obj_map

    def __iter__(self):
        return iter(self._obj_map.items())

    def __len__(self) -> int:
        return len(self._obj_map)
