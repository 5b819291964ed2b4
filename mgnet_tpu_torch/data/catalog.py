"""Dataset and metadata catalogs.

A copy of ``mgnet_tpu/data/catalog.py``: datasets register a loader
function returning a list of per-image dicts (``DatasetCatalog``), and
each name has a mutable metadata record (``MetadataCatalog``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List

__all__ = ["DatasetCatalog", "Metadata", "MetadataCatalog"]


class _DatasetCatalog:
    def __init__(self):
        self._loaders: Dict[str, Callable[[], List[dict]]] = {}

    def register(self, name: str, loader: Callable[[], List[dict]]):
        if name in self._loaders:
            raise KeyError(f"Dataset '{name}' already registered")
        self._loaders[name] = loader

    def get(self, name: str) -> List[dict]:
        if name not in self._loaders:
            raise KeyError(
                f"Dataset '{name}' not registered. Available: "
                f"{sorted(self._loaders)}"
            )
        return self._loaders[name]()

    def list(self) -> List[str]:
        return sorted(self._loaders)

    def remove(self, name: str):
        self._loaders.pop(name, None)

    def clear(self):
        self._loaders.clear()


@dataclass
class Metadata:
    name: str = ""
    extra: Dict[str, Any] = field(default_factory=dict)

    def set(self, **kwargs) -> "Metadata":
        self.extra.update(kwargs)
        return self

    def __getattr__(self, key):
        extra = object.__getattribute__(self, "extra")
        if key in extra:
            return extra[key]
        raise AttributeError(f"Metadata '{self.name}' has no key '{key}'")

    def get(self, key, default=None):
        return self.extra.get(key, default)


class _MetadataCatalog:
    def __init__(self):
        self._meta: Dict[str, Metadata] = {}

    def get(self, name: str) -> Metadata:
        if name not in self._meta:
            self._meta[name] = Metadata(name=name)
        return self._meta[name]

    def clear(self):
        self._meta.clear()


DatasetCatalog = _DatasetCatalog()
MetadataCatalog = _MetadataCatalog()
