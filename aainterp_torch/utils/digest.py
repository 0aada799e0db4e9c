"""Memoized content digests for host operator tables.

Counterpart of ``aainterp/utils/digest.py``, carried over but for the
memo of ndarray subclasses (``array_digest``).

Every plan/linear-fn cache in the package is keyed by table CONTENT
(two operators with equal tables share one kernel plan).  Hashing the
content on every call would cost a host memcpy + hash of every table per
``apply_operator`` invocation, even on cache hits.

``array_digest`` hashes each array OBJECT once and memoizes by id()
with a weakref liveness guard (an id reused after garbage collection
cannot alias a stale entry, because the guard checks the weakref still
points at the queried array).  Tables are treated as immutable: every
table-making function in this package returns fresh arrays and no call site mutates
them in place; mutating a table after its first digest is unsupported
(the digest would go stale) — the same contract the plan caches already
rely on.

The digest is ``hash(bytes)`` (SipHash) — stable within a process,
which is all in-process LRU keys need.  Each hash is a cold path,
``build.digest`` (``utils.log.build_span``: counted in ``log.BUILDS``).
"""

from __future__ import annotations

import weakref

import numpy as np

from .log import build_span

# id(array) -> (weakref, digest).  The weakref's collection callback
# removes the entry, so the table never outgrows the live arrays.
_MEMO: dict = {}

# test/diagnostic counters: how many arrays were actually hashed vs
# served from the memo
_STATS = {"hashed": 0, "memo_hits": 0}


def _hash_array(a: np.ndarray) -> int:
    _STATS["hashed"] += 1
    with build_span("build.digest"):
        return hash(a.tobytes())


def array_digest(a) -> int:
    """Content hash of a host array, computed once per array object.  An
    ndarray subclass is memoized as itself: ``np.asarray`` of a memory map
    (a disk-cached operator's table) is a new view on every call, which
    would hash the whole table again each time."""
    a = np.asanyarray(a)
    k = id(a)
    ent = _MEMO.get(k)
    if ent is not None and ent[0]() is a:
        _STATS["memo_hits"] += 1
        return ent[1]
    d = _hash_array(a)
    try:
        ref = weakref.ref(a, lambda _r, _k=k: _MEMO.pop(_k, None))
    except TypeError:
        # non-weakref-able array subclass: return the digest unmemoized
        return d
    _MEMO[k] = (ref, d)
    return d


def digest_stats() -> dict:
    """Snapshot of the hash/memo counters (tests)."""
    return dict(_STATS)
