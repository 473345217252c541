"""Name→factory registries with decorator registration and fuzzy suggestions
(capability parity with dassl/utils/registry.py:7-69). The port's own copy
of leclip_tpu/utils/registry.py."""

from __future__ import annotations

import difflib
from typing import Callable, Dict, List


class Registry:
    def __init__(self, name: str):
        self._name = name
        self._table: Dict[str, Callable] = {}

    def register(self, obj: Callable = None, *, name: str = None):
        def deco(fn):
            key = name or fn.__name__
            if key in self._table:
                raise KeyError(f"{key!r} already registered in {self._name}")
            self._table[key] = fn
            return fn

        if obj is None:
            return deco
        return deco(obj)

    def get(self, key: str) -> Callable:
        if key not in self._table:
            hint = difflib.get_close_matches(key, self._table, n=3)
            raise KeyError(
                f"{key!r} not found in registry {self._name!r}; "
                f"available: {sorted(self._table)}; did you mean {hint}?"
            )
        return self._table[key]

    def keys(self) -> List[str]:
        return sorted(self._table)

    def __contains__(self, key: str) -> bool:
        return key in self._table


DATASET_REGISTRY = Registry("dataset")
TRAINER_REGISTRY = Registry("trainer")
EVALUATOR_REGISTRY = Registry("evaluator")
MODEL_REGISTRY = Registry("model")
