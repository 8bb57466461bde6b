"""List stores: the tier boundary between an IVF index and its bytes.

Counterpart of ``repro.storage.store`` (numpy only), with the same
admission, eviction and counters, so ``stats()`` after the same stream of
touches equals ``repro``'s.

An :class:`~repro_torch.retrieval.ivf.IVFIndex` that owns a ``store`` no
longer requires its encoded inverted lists to be resident — the search
path asks the store for each probed list and the store decides what
lives in RAM:

* :class:`ResidentStore` — every list in host memory (today's behaviour:
  results are unchanged; exists so the store-backed search path can be
  validated against an always-hot tier and so tests exercise the
  protocol without an artifact on disk).
* :class:`MmapStore` — a byte-budgeted hot tier over a
  :class:`~repro_torch.storage.format.ChunkReader` memmap.  Recently probed
  lists are promoted into an LRU of materialised host arrays; admission
  is probe-frequency aware (a list enters the hot tier on its second
  touch, so one-off cold scans cannot flush the Zipf head); pinned lists
  (delta-routing targets, anything the caller declares hot) never
  evict; and hit/miss/eviction/bytes-resident counters feed
  ``RetrievalService.stats()``.

Correctness contract: a store only changes *where* list bytes come
from, never *what* they are — searches through any store at any budget
are bit-identical to the fully-resident index (asserted per backend and
budget in ``tests/test_torch_storage.py``, and on the card by
``chip_smoke.py``'s tiered phase).

The router (centroids) and any delta segments layered above
(:class:`~repro_torch.retrieval.segments.SegmentedIndex`) are *structurally*
resident — they live on the index object itself, not in the store — so
routing and live updates never take a cold-tier miss.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Iterable, Protocol, runtime_checkable

import numpy as np

from repro_torch.storage.format import ChunkReader


@runtime_checkable
class ListStore(Protocol):
    """What the IVF search path needs from a list-storage tier."""

    n_lists: int
    max_len: int
    encoded_nbytes: int

    def get(self, list_id: int) -> tuple[np.ndarray, np.ndarray]:
        """One inverted list → ``(rows (n, w), ids (n,))`` host arrays."""
        ...

    def prefetch(self, list_ids: Iterable[int]) -> int:
        """Warm the hot tier for the given lists; returns lists touched."""
        ...

    def iter_lists(self):
        """Yield ``(list_id, rows, ids)`` for every list in id order,
        without perturbing hot-tier state — the save/compact walk."""
        ...

    def pin(self, list_ids: Iterable[int]) -> None: ...

    def unpin(self, list_ids: Iterable[int]) -> None: ...

    @property
    def fully_resident(self) -> bool: ...

    def stats(self) -> dict: ...


class ResidentStore:
    """Every list materialised in host memory — the always-hot tier."""

    def __init__(self, lists_rows: list[np.ndarray],
                 lists_ids: list[np.ndarray]):
        if len(lists_rows) != len(lists_ids):
            raise ValueError("rows/ids list count mismatch")
        self._rows = [np.ascontiguousarray(r) for r in lists_rows]
        self._ids = [np.ascontiguousarray(i, dtype=np.int32)
                     for i in lists_ids]
        if not self._rows:
            raise ValueError("ResidentStore needs at least one list")
        self.n_lists = len(self._rows)
        self.max_len = max((len(i) for i in self._ids), default=0)
        self.encoded_nbytes = sum(int(r.nbytes) for r in self._rows)
        self.storage_dtype = self._rows[0].dtype
        self.storage_width = int(self._rows[0].shape[1])
        self.hits = 0

    @classmethod
    def from_padded(cls, storage: np.ndarray, lists: np.ndarray
                    ) -> "ResidentStore":
        """Build from the resident layout: row-major ``storage`` plus the
        (nlist, max_len) −1-padded list table."""
        storage = np.asarray(storage)
        lists = np.asarray(lists)
        rows, ids = [], []
        for row in lists:
            members = row[row >= 0].astype(np.int32)
            rows.append(storage[members])
            ids.append(members)
        return cls(rows, ids)

    def get(self, list_id: int) -> tuple[np.ndarray, np.ndarray]:
        self.hits += 1
        return self._rows[list_id], self._ids[list_id]

    def prefetch(self, list_ids: Iterable[int]) -> int:
        return len(tuple(list_ids))          # already hot

    def iter_lists(self):
        for lid, (rows, ids) in enumerate(zip(self._rows, self._ids)):
            yield lid, rows, ids

    def pin(self, list_ids: Iterable[int]) -> None:
        pass                                 # everything is pinned

    def unpin(self, list_ids: Iterable[int]) -> None:
        pass

    @property
    def fully_resident(self) -> bool:
        return True

    def stats(self) -> dict:
        return {"kind": "resident", "n_lists": self.n_lists,
                "resident_lists": self.n_lists, "pinned_lists": 0,
                "bytes_resident": self.encoded_nbytes,
                "budget_bytes": self.encoded_nbytes,
                "encoded_nbytes": self.encoded_nbytes,
                "hits": self.hits, "misses": 0, "evictions": 0,
                "hit_rate": 1.0 if self.hits else 0.0,
                "fully_resident": True}


class MmapStore:
    """Byte-budgeted hot tier over a memory-mapped chunked artifact.

    ``budget_bytes`` bounds the *hot tier* (materialised host copies of
    encoded list rows); the mmap itself is the OS's problem and costs no
    anonymous memory.  Admission is frequency-aware: a list is promoted
    once it has been touched ``admit_after`` times (default 2 — the
    first touch serves straight from the map, so a one-shot cold scan
    never evicts the working set), or immediately when prefetched or
    pinned.  Eviction is LRU among unpinned lists.  Each chunk's CRC-32
    is verified on its first read from the map, never again for that
    list.
    """

    def __init__(self, reader: ChunkReader, budget_bytes: int, *,
                 admit_after: int = 2):
        if budget_bytes < 0:
            raise ValueError("budget_bytes must be ≥ 0")
        self.reader = reader
        self.budget_bytes = int(budget_bytes)
        self.admit_after = max(1, int(admit_after))
        self.n_lists = reader.n_lists
        self.max_len = reader.max_len
        self.encoded_nbytes = reader.encoded_nbytes
        self.storage_dtype = reader.storage_dtype
        self.storage_width = reader.storage_width
        self._hot: "OrderedDict[int, tuple[np.ndarray, np.ndarray]]" = \
            OrderedDict()
        self._pinned: set[int] = set()
        self._touches = np.zeros(reader.n_lists, np.int64)
        self._verified = np.zeros(reader.n_lists, bool)
        self.bytes_resident = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.bytes_read = 0

    # -- internals ---------------------------------------------------------
    def _read(self, list_id: int) -> tuple[np.ndarray, np.ndarray]:
        rows, ids = self.reader.read_list(
            list_id, verify=not self._verified[list_id])
        self._verified[list_id] = True
        self.bytes_read += int(rows.nbytes) + int(ids.nbytes)
        return rows, ids

    def _admit(self, list_id: int, rows: np.ndarray,
               ids: np.ndarray) -> None:
        nbytes = int(rows.nbytes)
        if list_id not in self._pinned and nbytes > self.budget_bytes:
            return                      # one list larger than the whole tier
        # copy out of the map: a hot entry must not keep a page pinned
        self._hot[list_id] = (np.array(rows), np.array(ids))
        self._hot.move_to_end(list_id)
        self.bytes_resident += nbytes
        self._evict_to_budget()

    def _evict_to_budget(self) -> None:
        while self.bytes_resident > self.budget_bytes:
            victim = next((lid for lid in self._hot
                           if lid not in self._pinned), None)
            if victim is None:
                return                  # only pinned lists remain
            rows, _ = self._hot.pop(victim)
            self.bytes_resident -= int(rows.nbytes)
            self.evictions += 1

    # -- ListStore protocol ------------------------------------------------
    def get(self, list_id: int) -> tuple[np.ndarray, np.ndarray]:
        entry = self._hot.get(list_id)
        if entry is not None:
            self._hot.move_to_end(list_id)
            self.hits += 1
            return entry
        self.misses += 1
        self._touches[list_id] += 1
        rows, ids = self._read(list_id)
        if list_id in self._pinned or \
                self._touches[list_id] >= self.admit_after:
            self._admit(list_id, rows, ids)
        return rows, ids

    def prefetch(self, list_ids: Iterable[int]) -> int:
        """Promote the given lists ahead of scoring (the ``prefetch``
        hook: the router's probe table warms the tier before the search
        path asks for bytes)."""
        n = 0
        for lid in list_ids:
            lid = int(lid)
            self._touches[lid] += 1
            if lid not in self._hot:
                self._admit(lid, *self._read(lid))
            n += 1
        return n

    def iter_lists(self):
        """Walk every list straight off the map (hot tier untouched, no
        counter churn) — verifying each unverified chunk's CRC once."""
        for lid in range(self.n_lists):
            rows, ids = self.reader.read_list(
                lid, verify=not self._verified[lid])
            self._verified[lid] = True
            yield lid, rows, ids

    def pin(self, list_ids: Iterable[int]) -> None:
        """Make lists unevictable (and resident now) — e.g. the routing
        targets of live delta segments."""
        for lid in list_ids:
            lid = int(lid)
            self._pinned.add(lid)
            if lid not in self._hot:
                self._admit(lid, *self._read(lid))

    def unpin(self, list_ids: Iterable[int]) -> None:
        for lid in list_ids:
            self._pinned.discard(int(lid))
        self._evict_to_budget()

    @property
    def fully_resident(self) -> bool:
        return len(self._hot) == self.n_lists

    def stats(self) -> dict:
        touched = self.hits + self.misses
        return {"kind": "mmap", "n_lists": self.n_lists,
                "resident_lists": len(self._hot),
                "pinned_lists": len(self._pinned),
                "bytes_resident": self.bytes_resident,
                "budget_bytes": self.budget_bytes,
                "encoded_nbytes": self.encoded_nbytes,
                "hits": self.hits, "misses": self.misses,
                "evictions": self.evictions,
                "bytes_read": self.bytes_read,
                "hit_rate": (self.hits / touched) if touched else 0.0,
                "fully_resident": self.fully_resident}
