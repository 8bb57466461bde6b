"""RetrievalService: the multi-index serving front door.

Counterpart of ``repro.serve.service`` over the port's indexes: the same
locks, admission, canary and stats.  Artifacts load on ``device=``
(``None``: CUDA), sharded with ``shard=ShardSpec(...)``.

One process-wide object fronts a registry of **named, versioned indexes**
(each backed by an in-memory index or lazily loaded from a
:func:`repro_torch.retrieval.api.save_index` artifact), serves an **async
request API** from a background drain-loop thread with admission control,
and hot-swaps index versions under live traffic with zero downtime::

    service = RetrievalService()
    service.register("wiki", artifact="wiki_v1.npz")
    handle = service.query(queries, QueryOptions(index="wiki", k=20,
                                                 nprobe=8))
    scores, ids = handle.result(timeout=5.0)

    # nightly KB refresh, while producers keep submitting:
    service.stage("wiki", artifact="wiki_v2.npz", canary_every=4)
    ...                                    # canary overlap accumulates
    service.promote("wiki", min_overlap=0.6)   # atomic flip
    service.rollback("wiki")                   # undo, also atomic

    # live churn (mutable indexes, IndexSpec(mutable=True)):
    service.update("wiki", add=new_docs, delete=[12, 9041])
    if service.stats()["indexes"]["wiki"]["versions"][1]["mutable"] \
            ["needs_compaction"]:          # drift / delta-fraction trigger
        service.compact("wiki")            # fold + stage + promote, no pause

Design points:

* **Version binding** — a request binds to the live version *at submit
  time* and drains against that version's engine even if a promote lands
  while it is queued, so every result ranks entirely against the pre- or
  post-promote index, never a mix.  Retired versions keep draining until
  empty, then are garbage-collected.
* **Admission control** — queued rows are bounded by
  ``max_pending_queries``; past it, :meth:`query` raises :class:`QueueFull`
  instead of letting the queue grow without bound (callers shed load or
  retry — the standard back-pressure contract).
* **Canary** — ``stage(..., canary_every=N)`` attaches a
  :class:`~repro_torch.serve.shadow.ShadowScorer` over the *staged* index to the
  live engine: every Nth served batch is re-scored on the staged version
  and the top-k overlap tracked, so ``promote(min_overlap=...)`` can
  refuse to flip to a bad build using real traffic as the judge.
* **One dispatcher** — a single background thread drains every engine
  (micro-batching per ``(index version, k, nprobe)`` group), which is the
  standard accelerator topology: many frontends, one device dispatcher.
  Constructing with ``start=False`` gives a manual service —
  :meth:`drain_once` is then the caller's dispatch step (used by tests and
  the benchmark's "manual loop" baseline).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional

import numpy as np

from repro_torch.retrieval.segments import SegmentedIndex
from repro_torch.serve.batcher import MicroBatcher
from repro_torch.serve.cache import ResultCache
from repro_torch.serve.engine import ServeResult
from repro_torch.serve.limits import RateLimiter
from repro_torch.serve.metrics import LatencyStats
from repro_torch.serve.router import IndexEntry, IndexRegistry, IndexVersion
from repro_torch.serve.shadow import ShadowScorer
from repro_torch.serve.stats import (IndexStats, ServiceStats, ShardStats,
                               VersionStats)


class QueueFull(RuntimeError):
    """Admission control rejected the request: queue depth at the bound."""


class RateLimited(QueueFull):
    """The index's rate-limit policy shed this request (subclass of
    :class:`QueueFull` so one ``except`` arm handles both shed paths)."""


class CanaryFailed(RuntimeError):
    """``promote(min_overlap=...)`` found the staged version too different
    from live traffic's rankings."""


class ServiceClosed(RuntimeError):
    """The service is closed (or closed before this request completed)."""


@dataclasses.dataclass(frozen=True)
class QueryOptions:
    """Per-request routing and search options.

    ``index`` names the registry entry; ``k`` overrides the engine's
    default ranking length (``None`` keeps it); ``nprobe`` overrides the
    probe width for IVF-backed indexes.  Each distinct ``(k, nprobe)``
    value forms its own micro-batch group — offer a small fixed menu, not
    a continuous knob.

    ``lane`` names the rate-limit lane this request bills against (see
    :meth:`RetrievalService.set_rate_limit`); lanes without a configured
    cap share the index's full budget.
    """

    index: str = "default"
    k: Optional[int] = None
    nprobe: Optional[int] = None
    lane: str = "default"

    def __post_init__(self):
        if self.k is not None and self.k < 1:
            raise ValueError("k must be ≥ 1")
        if self.nprobe is not None and self.nprobe < 1:
            raise ValueError("nprobe must be ≥ 1")
        if not self.lane:
            raise ValueError("lane must be a non-empty string")


class QueryHandle:
    """Async result for one submitted query block.

    The drain loop resolves it; :meth:`result` blocks until then (or
    raises ``TimeoutError``).  A handle resolves exactly once — either
    with a :class:`~repro_torch.serve.engine.ServeResult` or with the error that
    killed its dispatch.
    """

    def __init__(self, index: str, version: int, request_id: int,
                 n_rows: int):
        self.index = index
        self.version = version              # the version this request bound to
        self.request_id = request_id
        self.n_rows = n_rows
        self._event = threading.Event()
        self._result: Optional[ServeResult] = None
        self._error: Optional[BaseException] = None
        self._cache_keys = None             # set when a result cache is on

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> ServeResult:
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"request {self.request_id} on {self.index!r} "
                f"v{self.version} still pending after {timeout}s")
        if self._error is not None:
            raise self._error
        return self._result

    # -- called by the drain loop only ------------------------------------
    def _resolve(self, result: ServeResult) -> None:
        self._result = result
        self._event.set()

    def _fail(self, error: BaseException) -> None:
        self._error = error
        self._event.set()

    def __repr__(self) -> str:
        state = "done" if self.done() else "pending"
        return (f"QueryHandle({self.index!r} v{self.version} "
                f"req={self.request_id} rows={self.n_rows} {state})")


class RetrievalService:
    """Multi-index serving front door with versioned hot-swap."""

    def __init__(self, *, default_k: int = 10, max_batch: int = 64,
                 max_pending_queries: int = 4096,
                 poll_interval_s: float = 0.05, start: bool = True,
                 batcher: Optional[MicroBatcher] = None,
                 cache_rows: int = 0,
                 limiter: Optional[RateLimiter] = None):
        """``batcher`` overrides the default fixed-cap
        :class:`~repro_torch.serve.batcher.MicroBatcher` (pass an
        :class:`~repro_torch.serve.batcher.AdaptiveBatcher` for depth-driven
        micro-batch sizing); ``cache_rows > 0`` enables the hot-query
        result cache (:mod:`repro_torch.serve.cache`) bounded to that many row
        entries; ``limiter`` installs per-index rate-limit policies (or
        use :meth:`set_rate_limit`)."""
        self.default_k = default_k
        self.max_pending_queries = max_pending_queries
        self._batcher = batcher if batcher is not None \
            else MicroBatcher(max_batch=max_batch)
        self._registry = IndexRegistry()
        self._lock = threading.RLock()      # registry + version pointers
        self._admission = threading.Lock()  # pending-row accounting
        self._update_lock = threading.Lock()  # serialise update/compact
        self._pending_queries = 0
        self._pending_high_water = 0
        self._cache = ResultCache(max_rows=cache_rows) if cache_rows else None
        self._cache_epochs: dict[str, int] = {}   # guarded by self._lock
        self._limiter = limiter if limiter is not None else RateLimiter()
        self.requests_admitted = 0
        self.requests_rejected = 0
        self.requests_rate_limited = 0
        self.cache_hits = 0
        self.updates_applied = 0
        self.compactions_run = 0
        self._poll_interval_s = poll_interval_s
        self._kick = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        if start:
            self.start()

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "RetrievalService":
        """Start the background drain loop (idempotent)."""
        with self._lock:
            self._check_open_locked()
            if self._thread is None:
                self._stop.clear()
                self._thread = threading.Thread(
                    target=self._run, name="retrieval-service-drain",
                    daemon=True)
                self._thread.start()
        return self

    def close(self, *, drain: bool = True) -> None:
        """Stop serving: optionally drain pending work, stop the thread,
        and fail any handle still unresolved with :class:`ServiceClosed`."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        if drain:
            self.drain_once()
        self._stop.set()
        self._kick.set()
        with self._lock:
            thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=10.0)
        leftovers = []
        with self._lock:
            for entry in self._registry.entries():
                for iv in entry.versions.values():
                    with iv.lock:
                        leftovers.extend(iv.handles.values())
                        iv.handles.clear()
        if leftovers:
            with self._admission:
                self._pending_queries -= sum(h.n_rows for h in leftovers)
            err = ServiceClosed("service closed before request completed")
            for h in leftovers:
                h._fail(err)

    def __enter__(self) -> "RetrievalService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _check_open_locked(self) -> None:
        if self._closed:
            raise ServiceClosed("service is closed")

    # -- registry ----------------------------------------------------------
    def register(self, name: str, index=None, *,
                 artifact: Optional[str] = None, lazy: bool = False,
                 mesh=None, shard=None, backend: Optional[str] = None,
                 k: Optional[int] = None,
                 resident_budget=None, device=None) -> int:
        """Register a named index; returns its version number (1).

        Exactly one of ``index`` (an in-memory object implementing the
        :class:`~repro_torch.retrieval.api.Index` protocol) or ``artifact`` (a
        ``save_index`` ``.npz`` path or chunked artifact directory).  With
        ``lazy=True`` the artifact's arrays are not loaded until the first
        query routes to it — only the identity header is read up front.
        ``shard`` (a :class:`~repro_torch.retrieval.api.ShardSpec`) loads
        the artifact sharded over the mesh the spec describes (``mesh``:
        the deprecated explicit mesh); ``backend`` and ``device``
        (``None``: CUDA) forward to
        :func:`~repro_torch.retrieval.api.load_index`.  ``resident_budget``
        forwards as ``load_index(..., resident=...)`` for chunked (v3)
        artifacts: ``None`` means ``"auto"``; an int byte budget serves
        the encoded lists from a memory-mapped hot/cold tier; ``"all"``
        forces full materialisation.

        Registration is all-or-none: a failing eager load (bad artifact,
        placement failure on any shard) leaves the registry untouched.
        """
        with self._lock:
            self._check_open_locked()
            if name in self._registry:
                raise ValueError(f"index {name!r} already registered — "
                                 "use stage()/promote() to ship a new "
                                 "version")
            entry = IndexEntry(name)
            iv = IndexVersion(entry.allocate(), index=index,
                              artifact=artifact, mesh=mesh, shard=shard,
                              backend=backend,
                              k=k or self.default_k, batcher=self._batcher,
                              resident=("auto" if resident_budget is None
                                        else resident_budget),
                              device=device)
            entry.versions[iv.version] = iv
            entry.live = iv.version
        if not lazy:
            iv.ensure_engine()          # outside the lock; raises → no entry
        with self._lock:
            self._check_open_locked()
            self._registry.add(entry)   # raises on duplicate; nothing leaks
        return iv.version

    def indexes(self) -> list[str]:
        with self._lock:
            return self._registry.names()

    # -- rate limiting -----------------------------------------------------
    def set_rate_limit(self, name: str, *, qps: float,
                       burst: Optional[float] = None,
                       lanes: Optional[dict[str, float]] = None) -> None:
        """Install/replace the rate-limit policy for index ``name``:
        sustained ``qps`` in query *rows* per second, ``burst`` bucket
        capacity (default one second of qps), and ``lanes`` mapping a
        :class:`QueryOptions` lane name to the fraction of qps it may use
        (capped lanes shed their own overload; unlisted lanes share the
        full budget).  Raises ``KeyError`` for an unregistered index."""
        with self._lock:
            self._check_open_locked()
            self._registry.get(name)          # raise before installing
        self._limiter.configure(name, qps=qps, burst=burst, lanes=lanes)

    def clear_rate_limit(self, name: str) -> bool:
        return self._limiter.remove(name)

    # -- request side ------------------------------------------------------
    def query(self, queries, options: Optional[QueryOptions] = None,
              **kw) -> QueryHandle:
        """Submit a query block; returns a :class:`QueryHandle` at once.

        ``options`` is a :class:`QueryOptions`; as a convenience the same
        fields may be given as keywords (``service.query(q, index="wiki",
        k=5)``).  Raises :class:`QueueFull` when admission control rejects
        the block, :class:`RateLimited` when the index's rate-limit policy
        sheds it, ``KeyError`` for an unknown index name.

        With the result cache enabled, a block whose every row is cached
        for the live version resolves immediately — no admission charge,
        no dispatch — with results bit-identical to the search it skipped.
        """
        if options is None:
            options = QueryOptions(**kw)
        elif kw:
            raise TypeError("pass QueryOptions or keyword options, not both")
        q = np.asarray(queries, dtype=np.float32)
        if q.ndim == 1:
            q = q[None, :]
        if q.ndim != 2 or q.shape[0] == 0:
            raise ValueError("queries must be (n ≥ 1, d) or (d,), got "
                             f"shape {np.shape(queries)}")
        n = int(q.shape[0])

        with self._lock:
            self._check_open_locked()
            entry = self._registry.get(options.index)
            version = entry.live_version()
            version.binders += 1       # pin against GC until submitted
            epoch = self._cache_epochs.get(entry.name, 0)
        try:
            engine = version.ensure_engine()   # lazy load, outside the lock

            cache_keys = None
            if self._cache is not None:
                t0 = time.perf_counter()
                k_eff = engine.k if options.k is None else options.k
                cache_keys = ResultCache.keys_for(
                    entry.name, epoch, version.version, k_eff,
                    options.nprobe, q)
                hit = self._cache.lookup(cache_keys)
                if hit is not None:
                    scores, ids = hit
                    handle = QueryHandle(entry.name, version.version, -1, n)
                    handle._resolve(ServeResult(
                        request_id=-1, scores=scores, ids=ids,
                        latency_s=time.perf_counter() - t0))
                    with self._admission:
                        self.cache_hits += 1
                    return handle

            # shed *before* admission: rate-limited traffic must never
            # occupy queue capacity that surviving traffic needs
            if not self._limiter.allow(entry.name, options.lane, n):
                with self._admission:
                    self.requests_rate_limited += 1
                raise RateLimited(
                    f"index {options.index!r}: lane {options.lane!r} "
                    f"over its rate-limit budget ({n} rows shed)")

            # the depth check and the counter bump are one atomic step
            # under the admission lock: concurrent producers can never
            # both pass a check that only has room for one of them
            with self._admission:
                if self._pending_queries + n > self.max_pending_queries:
                    self.requests_rejected += 1
                    raise QueueFull(
                        f"index {options.index!r}: {n} rows would push "
                        f"queue depth past max_pending_queries="
                        f"{self.max_pending_queries} "
                        f"({self._pending_queries} pending)")
                self._pending_queries += n
                self.requests_admitted += 1
                if self._pending_queries > self._pending_high_water:
                    self._pending_high_water = self._pending_queries
            try:
                # holding version.lock across submit+register means the
                # drain loop (which takes it before popping handles) can
                # never see a result whose handle isn't registered yet
                with version.lock:
                    rid = engine.submit(q, nprobe=options.nprobe,
                                        k=options.k)
                    handle = QueryHandle(entry.name, version.version, rid,
                                         n)
                    handle._cache_keys = cache_keys
                    version.handles[rid] = handle
            except BaseException:
                with self._admission:
                    self._pending_queries -= n
                raise
        finally:
            with self._lock:
                version.binders -= 1
        self._kick.set()
        return handle

    @property
    def pending_queries(self) -> int:
        with self._admission:
            return self._pending_queries

    # -- dispatch side -----------------------------------------------------
    def _run(self) -> None:
        while not self._stop.is_set():
            if not self.drain_once():
                self._kick.wait(self._poll_interval_s)
                self._kick.clear()

    def drain_once(self) -> int:
        """Drain every engine with pending work; resolve handles.

        Returns the number of requests resolved.  The background thread
        calls this in a loop; with ``start=False`` it is the caller's
        manual dispatch step.
        """
        with self._lock:
            work = [(entry, iv) for entry in self._registry.entries()
                    for iv in list(entry.versions.values()) if iv.loaded]
        resolved = 0
        for _entry, iv in work:
            engine = iv.engine
            if engine.pending == 0:
                continue
            try:
                results = engine.drain()
            except Exception as e:
                self._fail_version(iv, e)
                continue
            if not results:
                continue
            with iv.lock:
                handles = {rid: iv.handles.pop(rid) for rid in results
                           if rid in iv.handles}
            with self._admission:
                self._pending_queries -= sum(h.n_rows
                                             for h in handles.values())
            for rid, res in results.items():
                h = handles.get(rid)
                if h is not None:
                    if self._cache is not None and \
                            h._cache_keys is not None:
                        # keys carry the epoch read at submit time: if an
                        # update landed since, these rows are already
                        # unreachable — the insert is harmlessly stale
                        self._cache.put(h._cache_keys, res.scores, res.ids)
                    h._resolve(res)
            resolved += len(handles)
        self._gc()
        return resolved

    def _fail_version(self, iv: IndexVersion, error: Exception) -> None:
        """A drain blew up: every outstanding request on that version was
        popped from its queue, so fail all of its handles."""
        with iv.lock:
            handles, iv.handles = dict(iv.handles), {}
        with self._admission:
            self._pending_queries -= sum(h.n_rows for h in handles.values())
        for h in handles.values():
            h._fail(error)

    def _gc(self) -> None:
        """Drop retired versions (not live/staged/previous) once drained.

        A version pinned by an in-flight :meth:`query` binding survives,
        and a retired engine's counters fold into the entry's carry-over
        totals so the service-level rollup never goes backwards.
        """
        with self._lock:
            for entry in self._registry.entries():
                for vid in entry.retired():
                    iv = entry.versions[vid]
                    if iv.binders:
                        continue
                    if iv.loaded:
                        if iv.engine.pending or iv.handles:
                            continue
                        for key in entry.retired_totals:
                            entry.retired_totals[key] += \
                                getattr(iv.engine, key)
                        entry.retired_latency = LatencyStats.merge(
                            [entry.retired_latency, iv.engine.latency])
                        entry.retired_request_latency = LatencyStats.merge(
                            [entry.retired_request_latency,
                             iv.engine.request_latency])
                    del entry.versions[vid]

    # -- hot swap ----------------------------------------------------------
    def stage(self, name: str, index=None, *, artifact: Optional[str] = None,
              mesh=None, shard=None, backend: Optional[str] = None,
              k: Optional[int] = None, canary_every: int = 0,
              resident_budget=None, device=None) -> int:
        """Load the next version of ``name`` off the serving path.

        The artifact load (or in-memory adoption) and engine construction
        happen in the *calling* thread; live traffic keeps draining
        throughout.  Staging is all-or-none: for a sharded load
        (``shard=ShardSpec(...)`` or a sharded artifact), either every
        shard places on its device or the whole stage raises with the
        registry untouched — a partially placed version can never become
        visible to :meth:`promote`.  ``canary_every=N`` additionally
        attaches a :class:`~repro_torch.serve.shadow.ShadowScorer` over the
        staged index to the live engine: every Nth served batch is
        re-scored on the staged version and the top-k overlap recorded
        (see :meth:`canary`, ``promote(min_overlap=...)``).  Staging again
        replaces a previous staged version.  ``resident_budget`` (the
        chunked-artifact residency knob) and ``device`` are as in
        :meth:`register`.  Returns the new version number.
        """
        with self._lock:
            self._check_open_locked()
            entry = self._registry.get(name)
            vid = entry.allocate()
            live_iv = entry.live_version()
        iv = IndexVersion(vid, index=index, artifact=artifact, mesh=mesh,
                          shard=shard, backend=backend,
                          k=k or self.default_k,
                          batcher=self._batcher,
                          resident=("auto" if resident_budget is None
                                    else resident_budget),
                          device=device)
        staged_engine = iv.ensure_engine()  # pay the load here, not at promote
        if canary_every:
            live_iv.ensure_engine()
        with self._lock:
            entry = self._registry.get(name)
            self._detach_canary(entry)
            entry.versions[vid] = iv
            entry.staged = vid              # old staged (if any) retires → GC
            entry.staged_compact = False    # replaced whatever was staged
            if canary_every:
                entry.canary = ShadowScorer(staged_engine.index,
                                            every=canary_every)
                live = entry.versions.get(entry.live)
                if live is not None and live.loaded:
                    entry.canary_host = live.engine
                    live.engine.add_observer(entry.canary)
        return vid

    def canary(self, name: str) -> Optional[dict]:
        """Canary snapshot for ``name``: ``{"overlap", "batches"}`` — the
        mean live-vs-staged top-k overlap and how many sampled batches it
        rests on.  ``None`` when nothing is staged with a canary."""
        with self._lock:
            c = self._registry.get(name).canary
            if c is None:
                return None
            return {"overlap": c.mean_overlap, "batches": len(c.overlaps)}

    def promote(self, name: str, *,
                min_overlap: Optional[float] = None) -> int:
        """Atomically flip the staged version of ``name`` live.

        With ``min_overlap``, the canary gate: the staged version must
        have observed at least one sampled batch and its mean overlap
        against live rankings must reach the threshold, else
        :class:`CanaryFailed` (the staged version stays staged — fix or
        re-stage).  The old live version keeps draining requests already
        bound to it and stays warm for :meth:`rollback`.  Returns the new
        live version number.
        """
        with self._lock:
            self._check_open_locked()
            entry = self._registry.get(name)
            if entry.staged is None:
                raise ValueError(f"index {name!r}: nothing staged")
            if min_overlap is not None:
                c = entry.canary
                if c is None:
                    raise ValueError(
                        f"index {name!r}: promote(min_overlap=...) needs "
                        "stage(..., canary_every=N)")
                if not c.overlaps:
                    raise CanaryFailed(
                        f"index {name!r}: canary observed no traffic yet")
                if c.mean_overlap < min_overlap:
                    raise CanaryFailed(
                        f"index {name!r}: canary overlap "
                        f"{c.mean_overlap:.3f} < required {min_overlap} "
                        f"({len(c.overlaps)} batches)")
            self._detach_canary(entry)
            entry.staged_compact = False
            vid = entry.promote()
            self._invalidate_cache(name)
            return vid

    def rollback(self, name: str) -> int:
        """Flip live back to the previous version (atomic, same contract
        as promote: in-flight requests finish on the version they bound
        to).  A staged canary, if any, is detached — its overlap was
        measured against the version being rolled away from.  Returns the
        now-live version number."""
        with self._lock:
            self._check_open_locked()
            entry = self._registry.get(name)
            self._detach_canary(entry)
            entry.staged_compact = False
            vid = entry.rollback()
            self._invalidate_cache(name)
            return vid

    # -- live updates ------------------------------------------------------
    def _live_mutable(self, name: str) -> tuple[IndexVersion, SegmentedIndex]:
        with self._lock:
            self._check_open_locked()
            entry = self._registry.get(name)
            if entry.staged_compact:
                raise RuntimeError(
                    f"index {name!r} has a compacted version staged "
                    "(compact(promote=False)) — updates are frozen until "
                    "you promote() or replace the staged version, or "
                    "they would silently vanish at the flip")
            iv = entry.live_version()
        engine = iv.ensure_engine()
        idx = engine.index
        if not isinstance(idx, SegmentedIndex):
            raise TypeError(
                f"index {name!r} v{iv.version} is immutable "
                f"({type(idx).__name__}) — build it with "
                "IndexSpec(mutable=True) (or wrap it in a SegmentedIndex) "
                "to take live updates")
        return iv, idx

    def update(self, name: str, *, add=None, delete=None) -> dict:
        """Apply live adds/deletes to the mutable index serving ``name``.

        ``add`` is a ``(n, d)`` doc block encoded through the index's
        *frozen* fitted pipeline into a new delta segment; ``delete`` is a
        sequence of global doc ids to tombstone.  Queries keep draining
        throughout — a query submitted after ``update`` returns will never
        see a deleted id and will rank the added docs exactly as a fresh
        build would.  Returns a report dict: ``added``/``deleted`` counts,
        the ``gid_range`` assigned to the added block (use these ids to
        delete later), and the index's ``mutable_stats()`` —
        ``drift``/``needs_compaction`` there is the compaction trigger.

        Updates mutate the in-memory index only; run :meth:`compact` (or
        ``save_index``) to produce a durable artifact.
        """
        if add is None and delete is None:
            raise ValueError("update needs add= (docs) and/or delete= "
                             "(global doc ids)")
        iv, idx = self._live_mutable(name)
        with self._update_lock:
            added = deleted = 0
            gid_range = None
            if delete is not None:
                # validate BEFORE the add lands so the pair is atomic: a
                # bad delete id must not leave half the update applied
                # (ids inside the pending add block remain deletable)
                n_pending = 0 if add is None else int(np.shape(add)[0])
                delete = idx.validate_ids(delete, n_pending_add=n_pending)
            if add is not None:
                first = idx.next_gid
                idx.add(add)
                added = idx.next_gid - first
                gid_range = (first, idx.next_gid)
            if delete is not None:
                deleted = idx.delete(delete)
            self.updates_applied += 1
            report = idx.mutable_stats()
            # bump *after* the mutation lands: every cache row whose epoch
            # was read before this line — including results computed
            # against the pre-update index but inserted later — is now
            # unreachable
            self._invalidate_cache(name)
        self._kick.set()
        return {"index": name, "version": iv.version, "added": added,
                "deleted": deleted, "gid_range": gid_range, **report}

    def compact(self, name: str, *, canary_every: int = 0,
                min_overlap: Optional[float] = None, promote: bool = True,
                k: Optional[int] = None, rng=None) -> int:
        """Fold the live mutable index's segments + tombstones into a
        fresh main and re-register it through stage → promote.

        The fold runs in the calling thread while the old version keeps
        draining queries — the swap itself is the same atomic pointer flip
        as an artifact refresh, so no request is lost and global doc ids
        are preserved across the swap.  ``canary_every=N`` shadow-scores
        every Nth live batch on the compacted index first;
        ``promote=False`` stages only (canary at leisure, then call
        :meth:`promote` yourself — further :meth:`update` calls are
        rejected meanwhile, since the staged fold is a snapshot of live
        and would drop them at the flip); ``min_overlap`` forwards to
        the promote gate.  Returns the staged (``promote=False``) or
        now-live version number.
        """
        with self._update_lock:
            iv, idx = self._live_mutable(name)
            compacted = idx.compact(rng=rng)
            vid = self.stage(name, index=compacted, k=k or iv._k,
                             canary_every=canary_every)
            if promote:
                vid = self.promote(name, min_overlap=min_overlap)
            else:
                # the staged fold is a snapshot of live: freeze updates
                # until it is promoted (or replaced), else an update would
                # silently vanish at the flip
                with self._lock:
                    self._registry.get(name).staged_compact = True
            self.compactions_run += 1
        self._kick.set()
        return vid

    def _detach_canary(self, entry) -> None:
        if entry.canary is not None:
            if entry.canary_host is not None:
                entry.canary_host.remove_observer(entry.canary)
            entry.canary = None
            entry.canary_host = None

    def _invalidate_cache(self, name: str) -> None:
        """Bump the index's cache epoch (race-free: in-flight inserts keyed
        on the old epoch become unreachable the instant this returns) and
        eagerly reclaim the dead entries."""
        with self._lock:
            self._cache_epochs[name] = self._cache_epochs.get(name, 0) + 1
        if self._cache is not None:
            self._cache.invalidate(name)

    # -- observability -----------------------------------------------------
    def stats_typed(self) -> ServiceStats:
        """Typed service-level snapshot: per-index version table +
        rolled-up totals and merged latency percentiles across every
        engine, as :class:`~repro_torch.serve.stats.ServiceStats`.

        ``latency`` holds the per-batch device-time summary;
        ``request_latency`` the per-request queue-entry → last-batch-done
        summary — the number an SLO is written against.
        ``queue_depth``/``queue_high_water``/``shed_rate`` are the
        backpressure gauges: depth is rows currently admitted-but-
        unresolved, shed rate is the fraction of arrivals turned away
        (admission bound + rate limit) over the service's lifetime.
        Versions serving a sharded index additionally carry a per-shard
        rollup (:class:`~repro_torch.serve.stats.ShardStats`).
        """
        with self._lock:
            snapshot = [(entry.name, entry.live, entry.staged,
                         entry.previous, entry.canary,
                         dict(entry.versions), dict(entry.retired_totals),
                         entry.retired_latency, entry.retired_request_latency)
                        for entry in self._registry.entries()]
        indexes: dict[str, IndexStats] = {}
        latencies: list[LatencyStats] = []
        request_latencies: list[LatencyStats] = []
        totals = {"requests_served": 0, "queries_served": 0,
                  "batches_served": 0, "requests_submitted": 0,
                  "queries_submitted": 0}
        for (name, live, staged, previous, canary, versions, retired,
             retired_latency, retired_request_latency) in snapshot:
            table: dict[int, VersionStats] = {}
            for vid, iv in sorted(versions.items()):
                vs = VersionStats(info=dict(iv.info), loaded=iv.loaded)
                if iv.loaded:
                    vs.engine = iv.engine.stats()
                    latencies.append(iv.engine.latency)
                    request_latencies.append(iv.engine.request_latency)
                    for key in totals:
                        totals[key] += vs.engine[key]
                    idx = iv.engine.index
                    if isinstance(idx, SegmentedIndex):
                        # the preprocessing-drift monitor lives here:
                        # mutable["drift"]["mean_shift"] vs the pipeline's
                        # fitted centering stats, plus needs_compaction
                        vs.mutable = idx.mutable_stats()
                    main = idx.main if isinstance(idx, SegmentedIndex) \
                        else idx
                    store = getattr(main, "store", None)
                    if store is not None:
                        # hot/cold tier gauges for store-backed (v3
                        # chunked, partially resident) versions
                        vs.tier = store.stats()
                    shard_fn = getattr(idx, "shard_stats", None)
                    rows = shard_fn() if shard_fn is not None else None
                    if rows is not None:    # None: single-host main
                        vs.shards = [ShardStats.from_dict(r) for r in rows]
                table[vid] = vs
            for key in totals:              # GC'd versions still count
                totals[key] += retired[key]
            latencies.append(retired_latency)
            request_latencies.append(retired_request_latency)
            indexes[name] = IndexStats(
                live=live, staged=staged, previous=previous,
                canary=(None if canary is None else
                        {"overlap": canary.mean_overlap,
                         "batches": len(canary.overlaps)}),
                versions=table,
                retired=retired,
            )
        with self._admission:
            queue_depth = self._pending_queries
            high_water = self._pending_high_water
            admitted = self.requests_admitted
            rejected = self.requests_rejected
            rate_limited = self.requests_rate_limited
            cache_hits = self.cache_hits
        with self._update_lock:
            updates_applied = self.updates_applied
            compactions_run = self.compactions_run
        arrivals = admitted + rejected + rate_limited
        shed = rejected + rate_limited
        limits = self._limiter.stats()
        return ServiceStats(
            indexes=indexes,
            pending_queries=queue_depth,
            queue_depth=queue_depth,
            queue_high_water=high_water,
            requests_admitted=admitted,
            requests_rejected=rejected,
            requests_rate_limited=rate_limited,
            shed_rate=(shed / arrivals) if arrivals else 0.0,
            cache_hits=cache_hits,
            updates_applied=updates_applied,
            compactions_run=compactions_run,
            totals=totals,
            latency=LatencyStats.merge(latencies).summary(),
            request_latency=LatencyStats.merge(
                request_latencies).summary(),
            cache=self._cache.stats() if self._cache is not None else None,
            limits=limits if limits else None,
        )

    def stats(self) -> dict:
        """Plain-dict snapshot — ``stats_typed().to_dict()``, the exact
        key shape this method has always returned (new in this schema:
        per-version ``"shards"`` rollup for sharded versions)."""
        return self.stats_typed().to_dict()
