"""Hot-query result cache for the serving front door.

Real query streams are Zipf-skewed — a small head of queries is asked
over and over — so the cheapest search is the one never dispatched.  The
cache stores *per-row* results keyed on everything that determines them:

    (index name, epoch, version, k, nprobe, query-row hash)

* **Per-row entries** — a multi-row block hits only if *every* row is
  cached (results assemble by stacking; row results are independent of
  batch composition, which the engine's batching-parity tests pin down).
  A miss dispatches the whole block and re-populates all its rows, so hot
  rows stay fresh no matter how they are mixed into blocks.
* **Version in the key** — a request binds to an index version at submit
  time; results cached for one version can never answer a query bound to
  another (hot-swap safety for free).
* **Epoch in the key** — live ``update``/``compact``/``promote``/
  ``rollback`` bump the index's epoch
  (:meth:`~repro_torch.serve.service.RetrievalService` owns the counter), which
  unreaches every older entry *immediately*, including inserts still in
  flight from requests that were computed before the mutation but resolve
  after it.  Invalidation is therefore race-free without any blocking on
  the serving path: stale entries simply can no longer be looked up, and
  the LRU evicts them.
* **Bit-identity** — an entry stores the exact arrays a real dispatch
  produced (copied in, copied out), so a cache hit is bit-identical to
  the uncached search it replaced.

Capacity is bounded in *rows* (one row entry ≈ one ``(k,)`` score + id
pair), evicted LRU.  Thread-safe; hit/miss/eviction/invalidation counters
feed the service ``stats()`` rollup.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import Optional

import numpy as np

#: cache key: (index, epoch, version, k, nprobe, row-digest)
CacheKey = tuple


def hash_query_row(row: np.ndarray) -> bytes:
    """Stable digest of one float32 query row (exact bytes, no tolerance:
    two queries hash together only when search would see identical
    inputs)."""
    row = np.ascontiguousarray(row, dtype=np.float32)
    return hashlib.blake2b(row.tobytes(), digest_size=16).digest()


class ResultCache:
    """LRU of per-row search results, bounded by ``max_rows``."""

    def __init__(self, max_rows: int = 65536):
        if max_rows < 1:
            raise ValueError("max_rows must be ≥ 1")
        self.max_rows = int(max_rows)
        self._rows: OrderedDict[CacheKey, tuple[np.ndarray, np.ndarray]] = \
            OrderedDict()
        self._mu = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.invalidations = 0
        self.inserts = 0

    @staticmethod
    def keys_for(index: str, epoch: int, version: int, k: int,
                 nprobe: Optional[int], queries: np.ndarray
                 ) -> list[CacheKey]:
        """Keys for every row of a query block (order preserved)."""
        q = np.ascontiguousarray(queries, dtype=np.float32)
        return [(index, epoch, version, k, nprobe, hash_query_row(row))
                for row in q]

    def lookup(self, keys: list[CacheKey]
               ) -> Optional[tuple[np.ndarray, np.ndarray]]:
        """All-rows-or-nothing: ``(scores, ids)`` stacked in key order when
        every row is present, else ``None``.  Counts one hit/miss per row.
        """
        with self._mu:
            entries = []
            for key in keys:
                e = self._rows.get(key)
                if e is None:
                    self.misses += len(keys)
                    return None
                entries.append(e)
            for key in keys:
                self._rows.move_to_end(key)
            self.hits += len(keys)
        scores = np.stack([e[0] for e in entries]).copy()
        ids = np.stack([e[1] for e in entries]).copy()
        return scores, ids

    def put(self, keys: list[CacheKey], scores: np.ndarray,
            ids: np.ndarray) -> None:
        """Insert one result row per key (``scores``/``ids`` are the
        block's ``(n, k)`` arrays; row i belongs to keys[i])."""
        scores = np.asarray(scores)
        ids = np.asarray(ids)
        with self._mu:
            for i, key in enumerate(keys):
                self._rows[key] = (scores[i].copy(), ids[i].copy())
                self._rows.move_to_end(key)
                self.inserts += 1
            while len(self._rows) > self.max_rows:
                self._rows.popitem(last=False)
                self.evictions += 1

    def invalidate(self, index: Optional[str] = None) -> int:
        """Drop entries for ``index`` (all indexes when ``None``).

        The epoch key already makes stale entries unreachable the instant
        the service bumps it; this reclaims their memory eagerly instead
        of waiting for LRU pressure.  Returns how many rows were dropped.
        """
        with self._mu:
            if index is None:
                dropped = len(self._rows)
                self._rows.clear()
            else:
                doomed = [key for key in self._rows if key[0] == index]
                for key in doomed:
                    del self._rows[key]
                dropped = len(doomed)
            self.invalidations += dropped
        return dropped

    def __len__(self) -> int:
        with self._mu:
            return len(self._rows)

    def stats(self) -> dict:
        with self._mu:
            total = self.hits + self.misses
            return {
                "rows": len(self._rows),
                "max_rows": self.max_rows,
                "hits": self.hits,
                "misses": self.misses,
                "hit_rate": (self.hits / total) if total else 0.0,
                "inserts": self.inserts,
                "evictions": self.evictions,
                "invalidations": self.invalidations,
            }
