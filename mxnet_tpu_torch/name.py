"""Automatic symbol naming (port of ``mxnet_tpu/name.py``, reference
python/mxnet/name.py NameManager)."""
from __future__ import annotations

from typing import Dict, Optional

__all__ = ["NameManager", "Prefix"]


class NameManager:
    _current: Optional["NameManager"] = None

    def __init__(self):
        self._counter: Dict[str, int] = {}
        self._old: Optional[NameManager] = None

    def get(self, name: Optional[str], hint: str) -> str:
        if name:
            return name
        if hint not in self._counter:
            self._counter[hint] = 0
        name = "%s%d" % (hint, self._counter[hint])
        self._counter[hint] += 1
        return name

    @classmethod
    def current(cls) -> "NameManager":
        if cls._current is None:
            cls._current = NameManager()
        return cls._current

    def __enter__(self):
        self._old = NameManager._current
        NameManager._current = self
        return self

    def __exit__(self, *args):
        NameManager._current = self._old


class Prefix(NameManager):
    """Prepends a prefix to all auto-generated names."""

    def __init__(self, prefix: str):
        super().__init__()
        self._prefix = prefix

    def get(self, name, hint):
        name = super().get(name, hint)
        return self._prefix + name
