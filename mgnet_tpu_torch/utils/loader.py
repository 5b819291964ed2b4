"""Dynamic object loading from dotted-path config strings.

A copy of ``mgnet_tpu/utils/loader.py``: ``locate`` resolves the dataset
mappers named in ``INPUT.TRAIN_DATASET_MAPPER`` /
``INPUT.TEST_DATASET_MAPPER``, so users swap in custom mappers purely via
config.
"""

from __future__ import annotations

import importlib
from typing import Any

__all__ = ["locate"]


def locate(dotted_path: str) -> Any:
    """Resolve ``"pkg.module.Attr"`` to the attribute object.

    Raises ImportError with the full path on failure — a misspelled mapper
    class in a config must fail loudly, not fall back silently.
    """
    module_path, _, attr = dotted_path.rpartition(".")
    if not module_path:
        raise ImportError(
            f"{dotted_path!r} is not a dotted module path (need pkg.mod.Attr)"
        )
    try:
        module = importlib.import_module(module_path)
    except ImportError as e:
        raise ImportError(f"cannot import module for {dotted_path!r}: {e}") from e
    try:
        return getattr(module, attr)
    except AttributeError as e:
        raise ImportError(
            f"module {module_path!r} has no attribute {attr!r} "
            f"(from config value {dotted_path!r})"
        ) from e
