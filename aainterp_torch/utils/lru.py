"""Bounded LRU mapping for host-side kernel-plan caches.

Counterpart of ``aainterp/utils/lru.py``.  The plan caches (kernel tile
plans with their device table copies, transposed bands, autograd
wrappers) are keyed by operator-content hashes; a long-lived server
resampling many geometries must not grow them without bound.  dict in
CPython preserves insertion order, so move-to-end on hit + evict-oldest
on insert gives LRU with no extra structure.

Each of the program's caches is a module constant with a ``name``
(``cuda_apply.plan``, ``api.shear3``, ...), counts its ``hits`` and
``misses``, and is found by that name in ``CACHES``; a miss is marked
``cache.<name>.miss`` in a profiler's trace (``utils.log.mark``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Hashable, Optional

import numpy as np
import torch

from .log import mark

# every named cache by its name: the program's module-level caches
CACHES: Dict[str, "LruDict"] = {}


def value_nbytes(value) -> int:
    """Total array bytes held by a cached value (host numpy arrays and
    torch tensors on any device), walking tuples/lists/dicts/dataclasses.
    Non-array leaves (callables, ints, specs) count 0 — the arrays are
    what pins host RAM / device memory."""
    seen: set = set()

    def walk(v) -> int:
        if v is None or isinstance(v, (int, float, str, bool, bytes)):
            return 0
        if id(v) in seen:
            return 0
        seen.add(id(v))
        if isinstance(v, torch.Tensor):
            return int(v.numel() * v.element_size())
        if isinstance(v, np.ndarray):
            return int(v.nbytes)
        if isinstance(v, dict):
            return sum(walk(x) for x in v.values())
        if isinstance(v, (tuple, list, set, frozenset)):
            return sum(walk(x) for x in v)
        if dataclasses.is_dataclass(v) and not isinstance(v, type):
            return sum(walk(getattr(v, f.name))
                       for f in dataclasses.fields(v))
        return 0

    return walk(value)


class LruDict:
    """Minimal LRU mapping: get/put/len/contains, evicts least-recent.

    With ``max_bytes`` set, eviction is ALSO by total array bytes
    (``value_nbytes`` per entry, computed once at put).  A single
    over-budget entry is still admitted (capacity >= 1 semantics): the
    cache then holds just it.

    With a ``name`` the cache registers itself in ``CACHES`` (a later one
    of the same name takes its place).  ``get`` counts ``hits`` and
    ``misses``.
    """

    def __init__(self, capacity: int, max_bytes: Optional[int] = None,
                 name: Optional[str] = None):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self.max_bytes = max_bytes
        self.total_bytes = 0
        self._d: dict = {}
        self._sz: dict = {}
        self.name = name
        self.hits = 0
        self.misses = 0
        self._miss_span = f"cache.{name}.miss"
        if name is not None:
            CACHES[name] = self

    def get(self, key: Hashable, default: Any = None) -> Optional[Any]:
        if key not in self._d:
            self.misses += 1
            mark(self._miss_span)
            return default
        self.hits += 1
        val = self._d.pop(key)   # re-insert: most-recent position
        self._d[key] = val
        return val

    def _evict_oldest(self) -> None:
        k = next(iter(self._d))
        self._d.pop(k)
        self.total_bytes -= self._sz.pop(k, 0)

    def put(self, key: Hashable, value: Any) -> None:
        if key in self._d:
            self._d.pop(key)
            self.total_bytes -= self._sz.pop(key, 0)
        while len(self._d) >= self.capacity:
            self._evict_oldest()
        sz = value_nbytes(value) if self.max_bytes is not None else 0
        if self.max_bytes is not None:
            while self._d and self.total_bytes + sz > self.max_bytes:
                self._evict_oldest()
        self._d[key] = value
        self._sz[key] = sz
        self.total_bytes += sz

    def values(self):
        """Snapshot of cached values, oldest first (does not promote)."""
        return list(self._d.values())

    def items(self):
        """Snapshot of (key, value) pairs, oldest first (no promotion)."""
        return list(self._d.items())

    def __len__(self) -> int:
        return len(self._d)

    def __contains__(self, key: Hashable) -> bool:
        return key in self._d

    def clear(self) -> None:
        self._d.clear()
        self._sz.clear()
        self.total_bytes = 0
