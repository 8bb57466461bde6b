"""Versioned index registry: the routing layer under ``RetrievalService``.

Counterpart of ``repro.serve.router``.  ``shard=`` (a ``ShardSpec``, or
the deprecated ``mesh=``) loads an artifact sharded, on ``device``.

The registry maps a *name* ("wiki", "datastore", …) to an
:class:`IndexEntry`; each entry owns a monotonically numbered set of
:class:`IndexVersion`\\ s and three pointers into it:

* ``live`` — the version new queries bind to,
* ``staged`` — the next version, loaded off the serving path, optionally
  canaried against live traffic, waiting for ``promote()``,
* ``previous`` — the last live version, kept warm for ``rollback()``.

A version wraps one :class:`~repro_torch.serve.engine.ServeEngine` execution
core plus provenance: the backing index is either handed over in memory or
lazily loaded from a :func:`repro_torch.retrieval.api.save_index` artifact path
on first use (the artifact's JSON header is read eagerly, so a bad path
fails at registration and the version carries identity metadata —
kind, corpus size, spec fingerprint — before any array is touched).

This module is deliberately lock-free data + invariants; all mutation
ordering (atomic promote flips, canary attach/detach, GC of retired
versions) is owned by :class:`repro_torch.serve.service.RetrievalService`.
"""

from __future__ import annotations

import threading
from typing import Iterator, Optional

from repro_torch.serve.batcher import MicroBatcher
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.metrics import LatencyStats
from repro_torch.utils import DeviceLike


def load_engine(artifact: str, *, mesh=None, shard=None,
                backend: Optional[str] = None, resident="auto",
                k: int = 10, batcher: Optional[MicroBatcher] = None,
                device: DeviceLike = None) -> ServeEngine:
    """The one cold-start adapter: artifact path → running engine.

    Every serve-side load — ``register(artifact=)``, ``stage(artifact=)``,
    and the deprecated ``ServeEngine.from_artifact`` — routes through
    :func:`repro_torch.retrieval.api.load_index` here, so placement
    (``shard=ShardSpec(...)``, or the spec embedded in a sharded
    artifact), backend override, and chunked-artifact residency behave
    identically no matter which door the artifact came in through.
    ``device`` is where the index lives (``None``: CUDA; for a sharded
    load, the device rule of :mod:`repro_torch.parallel.placement`).
    """
    from repro_torch.retrieval.api import load_index
    index = load_index(artifact, mesh=mesh, backend=backend,
                       resident=resident, shard=shard, device=device)
    return ServeEngine(index, k=k, batcher=batcher)


class IndexVersion:
    """One version of a named index: engine core + provenance.

    ``handles`` maps outstanding request ids to their
    :class:`~repro_torch.serve.service.QueryHandle`; ``lock`` serialises the
    submit-and-register-handle step against the drain loop's
    pop-and-resolve step, so a result can never arrive before its handle
    exists.
    """

    def __init__(self, version: int, *, index=None,
                 artifact: Optional[str] = None, mesh=None, shard=None,
                 backend: Optional[str] = None, k: int = 10,
                 batcher: Optional[MicroBatcher] = None,
                 resident="auto", device: DeviceLike = None):
        if (index is None) == (artifact is None):
            raise ValueError("IndexVersion needs exactly one of index= "
                             "(in-memory) or artifact= (saved artifact "
                             "path)")
        self.version = version
        self.artifact = artifact
        self.mesh = mesh
        self.shard = shard             # ShardSpec: load the artifact sharded
        self.backend = backend
        self.resident = resident       # residency knob for v3 artifacts
        self.device = device           # where an artifact loads
        self._k = k
        self._batcher = batcher
        self._engine: Optional[ServeEngine] = None
        self._load_lock = threading.Lock()
        self.lock = threading.Lock()
        self.handles: dict[int, object] = {}
        # in-flight query() bindings not yet submitted; guarded by the
        # service lock — GC must skip a pinned version or a request could
        # bind to it, lose it, and never resolve
        self.binders = 0
        if index is not None:
            self._engine = ServeEngine(index, k=k, batcher=batcher)
            self.info = {"source": "memory",
                         "kind": type(index).__name__,
                         "n_docs": len(index),
                         "mutable": hasattr(index, "mutable_stats")}
        else:
            from repro_torch.retrieval.api import load_index_meta
            self.info = {"source": artifact, **load_index_meta(artifact)}

    @property
    def loaded(self) -> bool:
        with self._load_lock:
            return self._engine is not None

    @property
    def engine(self) -> Optional[ServeEngine]:
        """The execution core, or ``None`` while still lazy."""
        with self._load_lock:
            return self._engine

    def ensure_engine(self) -> ServeEngine:
        """Load the backing artifact (once) and return the engine.

        Always acquires ``_load_lock`` — the previous double-checked bare
        read of ``_engine`` raced the loader's assignment with no memory
        ordering; an uncontended lock costs nothing on the hot path.
        """
        with self._load_lock:
            if self._engine is None:
                self._engine = load_engine(
                    self.artifact, mesh=self.mesh, shard=self.shard,
                    backend=self.backend, resident=self.resident,
                    k=self._k, batcher=self._batcher, device=self.device)
            return self._engine


class IndexEntry:
    """A named index: its versions and the live/staged/previous pointers."""

    def __init__(self, name: str):
        self.name = name
        self.versions: dict[int, IndexVersion] = {}
        self.live: Optional[int] = None
        self.staged: Optional[int] = None
        self.previous: Optional[int] = None
        self.canary = None          # ShadowScorer: live traffic vs. staged
        self.canary_host = None     # the engine the canary is attached to
        # True while a compact(promote=False) fold awaits promote: the
        # staged version is a snapshot of live, so live updates must be
        # frozen or they would silently vanish at the flip
        self.staged_compact = False
        # counters carried over from GC'd versions, so service-level
        # totals never go backwards across hot-swaps
        self.retired_totals = {"requests_served": 0, "queries_served": 0,
                               "batches_served": 0,
                               "requests_submitted": 0,
                               "queries_submitted": 0}
        self.retired_latency = LatencyStats()
        self.retired_request_latency = LatencyStats()
        self._next_version = 1

    def allocate(self) -> int:
        v = self._next_version
        self._next_version += 1
        return v

    def live_version(self) -> IndexVersion:
        return self.versions[self.live]

    def promote(self) -> int:
        """Atomic pointer flip: staged → live, old live → previous.

        The old live version stays registered (and keeps draining any
        requests already bound to it) until it is GC'd or rolled back to.
        """
        if self.staged is None:
            raise ValueError(f"index {self.name!r}: nothing staged")
        self.previous, self.live, self.staged = self.live, self.staged, None
        return self.live

    def rollback(self) -> int:
        """Swap live back to the previous version (promote's undo)."""
        if self.previous is None:
            raise ValueError(f"index {self.name!r}: no previous version "
                             "to roll back to")
        self.live, self.previous = self.previous, self.live
        return self.live

    def retired(self) -> list[int]:
        """Versions no pointer references — GC candidates once drained."""
        keep = {self.live, self.staged, self.previous}
        return [v for v in self.versions if v not in keep]


class IndexRegistry:
    """Name → :class:`IndexEntry` map with helpful failure messages."""

    def __init__(self):
        self._entries: dict[str, IndexEntry] = {}

    def add(self, entry: IndexEntry) -> IndexEntry:
        if entry.name in self._entries:
            raise ValueError(f"index {entry.name!r} already registered — "
                             "use stage()/promote() to ship a new version")
        self._entries[entry.name] = entry
        return entry

    def get(self, name: str) -> IndexEntry:
        try:
            return self._entries[name]
        except KeyError:
            known = ", ".join(sorted(self._entries)) or "<none>"
            raise KeyError(f"unknown index {name!r} (registered: {known})") \
                from None

    def entries(self) -> Iterator[IndexEntry]:
        return iter(list(self._entries.values()))

    def names(self) -> list[str]:
        return sorted(self._entries)

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def __len__(self) -> int:
        return len(self._entries)
