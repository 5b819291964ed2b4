"""Dataset metadata record (a copy of ``Metadata`` from
``mgnet_tpu/data/catalog.py``; the dataset registries come with a later
slice)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict

__all__ = ["Metadata"]


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
