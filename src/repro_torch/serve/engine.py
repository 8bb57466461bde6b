"""The per-index execution core: request queue → micro-batches → index.

Counterpart of ``repro.serve.engine``; the searches run on the index's
device and their results come to the host, as numpy arrays, where the
batch completes.

:class:`ServeEngine` fronts any index exposing ``search(queries, k)`` —
:class:`~repro_torch.retrieval.index.DenseIndex`,
:class:`~repro_torch.retrieval.index.CompressedIndex`,
:class:`~repro_torch.retrieval.ivf.IVFIndex` (resident or tiered), or a
:class:`~repro_torch.retrieval.segments.SegmentedIndex` over one.

Model: callers ``submit()`` query blocks (one or more rows) and receive a
request id; ``drain()`` coalesces everything pending through the
micro-batcher, dispatches each padded batch in one device call, and
returns completed :class:`ServeResult`\\ s.  ``submit`` is thread-safe, so
any number of producer threads can feed one drain loop (the standard
accelerator-serving topology: many frontends, one dispatcher).  The
multi-index front door over a fleet of engines — named registry entries,
versioned hot-swap, a background drain thread and an async handle API —
is :class:`repro_torch.serve.service.RetrievalService`; this class stays the
single-index core it dispatches to.

Requests may override ``k`` and (for IVF indexes) ``nprobe`` per
submission: latency-sensitive traffic probes fewer lists or asks for a
shorter ranking, recall-sensitive traffic more, against the same storage.
Requests are micro-batched per ``(k, nprobe)`` group (a batch runs one
search call), so frontends should offer a small fixed menu of widths
(e.g. fast/default/full), not a continuous per-user knob: every distinct
value splits the queue into smaller batches.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional

import numpy as np

from repro_torch.serve.batcher import MicroBatcher
from repro_torch.serve.metrics import LatencyStats
from repro_torch.serve.shadow import ShadowScorer, to_host


@dataclasses.dataclass
class ServeResult:
    request_id: int
    scores: np.ndarray           # (n, k)
    ids: np.ndarray              # (n, k)
    latency_s: float             # queue-entry → this request's last batch done


class ServeEngine:
    """Micro-batching search engine over a pluggable index."""

    def __init__(self, index, k: int = 10, batcher: Optional[MicroBatcher] = None,
                 shadow: Optional[ShadowScorer] = None):
        place = getattr(index, "place", None)
        if place is not None:
            # sharded index: force mesh placement before this engine can
            # become visible to the registry — every shard lands on its
            # device here or the stage/register aborts whole (all-or-none)
            place()
        self.index = index
        self.k = k
        self.batcher = batcher if batcher is not None else MicroBatcher()
        self.shadow = shadow
        self.latency = LatencyStats()          # per micro-batch device time
        self.request_latency = LatencyStats()  # per-request queue → done
        # one lock guards the queue AND every counter below: submit,
        # drain's counter updates, and stats() snapshots all take it, so a
        # stats() reader can never see requests_served without the matching
        # queries_served (and conservation — submitted == served + pending
        # + in flight — holds on every snapshot, not just at quiesce)
        self._lock = threading.Lock()
        self._pending: list[tuple[int, np.ndarray, Optional[int],
                                  Optional[int]]] = []
        self._submit_time: dict[int, float] = {}
        self._next_id = 0
        self._observers: list[ShadowScorer] = []
        self.queries_served = 0
        self.batches_served = 0
        self.requests_served = 0
        self.requests_submitted = 0
        self.queries_submitted = 0
        self._inflight_requests = 0            # popped by drain, not yet done
        self._inflight_rows = 0

    @classmethod
    def from_artifact(cls, path: str, k: int = 10, *, mesh=None,
                      backend: Optional[str] = None,
                      batcher: Optional[MicroBatcher] = None,
                      shadow: Optional[ShadowScorer] = None,
                      device=None) -> "ServeEngine":
        """Deprecated alias for the one cold-start path.

        Use :func:`repro_torch.serve.router.load_engine` (or register the
        artifact with :class:`~repro_torch.serve.service.RetrievalService`) —
        all three doors now route through the same
        :func:`repro_torch.retrieval.api.load_index` adapter, so this alias
        only survives for old callers.
        """
        import warnings
        warnings.warn(
            "ServeEngine.from_artifact is deprecated: use "
            "repro_torch.serve.router.load_engine (one loader for every "
            "cold-start path) or RetrievalService.register(artifact=...)",
            DeprecationWarning, stacklevel=2)
        from repro_torch.serve.router import load_engine
        engine = load_engine(path, mesh=mesh, backend=backend, k=k,
                             batcher=batcher, device=device)
        engine.shadow = shadow
        return engine

    # -- request side ------------------------------------------------------
    def submit(self, queries, nprobe: Optional[int] = None,
               k: Optional[int] = None) -> int:
        """Enqueue a block of queries; returns the request id.

        Thread-safe.  ``nprobe`` overrides the index's probe width for this
        request only (IVF indexes; rejected for indexes without one);
        ``k`` overrides the engine's default ranking length.
        """
        q = np.asarray(queries, dtype=np.float32)
        if q.ndim == 1:
            q = q[None, :]
        if q.ndim != 2:
            raise ValueError(f"queries must be (n, d) or (d,), got {q.shape}")
        if q.shape[0] == 0:
            raise ValueError("empty query block: submit needs ≥ 1 row, "
                             f"got shape {q.shape}")
        if k is not None and k < 1:
            raise ValueError("k must be ≥ 1")
        if nprobe is not None:
            if getattr(self.index, "nprobe", None) is None:
                raise ValueError("per-request nprobe needs an IVF index; "
                                 f"{type(self.index).__name__} has none")
            if nprobe < 1:
                raise ValueError("nprobe must be ≥ 1")
        now = time.perf_counter()
        with self._lock:
            request_id = self._next_id
            self._next_id += 1
            self._pending.append((request_id, q, k, nprobe))
            self._submit_time[request_id] = now
            self.requests_submitted += 1
            self.queries_submitted += q.shape[0]
        return request_id

    @property
    def pending(self) -> int:
        with self._lock:
            return sum(q.shape[0] for _, q, _, _ in self._pending)

    @property
    def pending_requests(self) -> int:
        with self._lock:
            return len(self._pending)

    # -- observers ---------------------------------------------------------
    def add_observer(self, observer: ShadowScorer) -> None:
        """Attach an extra shadow observer (e.g. a hot-swap canary) to the
        serving path; it sees the same sampled batches as ``shadow``."""
        with self._lock:
            self._observers.append(observer)

    def remove_observer(self, observer: ShadowScorer) -> None:
        with self._lock:
            if observer in self._observers:
                self._observers.remove(observer)

    # -- dispatch side -----------------------------------------------------
    def drain(self) -> dict[int, ServeResult]:
        """Serve everything pending; returns {request_id: ServeResult}.

        A request completes — and its ``latency_s`` is stamped — the
        moment the micro-batch carrying its *last* rows finishes, not when
        the whole drain does: requests answered by the first batch are
        never charged for later, unrelated batches in the same drain.
        """
        with self._lock:
            if not self._pending:
                return {}
            pending, self._pending = self._pending, []
            submit_time = {rid: self._submit_time.pop(rid)
                           for rid, _, _, _ in pending}
            self._inflight_requests += len(pending)
            self._inflight_rows += sum(q.shape[0] for _, q, _, _ in pending)
            observers = tuple(([self.shadow] if self.shadow is not None
                               else []) + self._observers)
            inflight_rows = self._inflight_rows
        if hasattr(self.batcher, "observe_depth"):   # adaptive sizing hook
            self.batcher.observe_depth(inflight_rows)
        out_scores: dict[int, np.ndarray] = {}
        out_ids: dict[int, np.ndarray] = {}
        rows_left: dict[int, int] = {}
        for rid, q, _, _ in pending:
            n = q.shape[0]
            out_scores[rid] = np.empty((n, 0), np.float32)
            out_ids[rid] = np.empty((n, 0), np.int32)
            rows_left[rid] = n

        # micro-batch per (k, nprobe) group: one search call per batch.
        # FIFO order is preserved within each group.
        groups: dict[tuple[int, Optional[int]],
                     list[tuple[int, np.ndarray]]] = {}
        for rid, q, k, nprobe in pending:
            key = (self.k if k is None else k, nprobe)
            groups.setdefault(key, []).append((rid, q))

        results: dict[int, ServeResult] = {}
        for (k, nprobe), items in groups.items():
            kwargs = {} if nprobe is None else {"nprobe": nprobe}
            for batch in self.batcher.form(items):
                t0 = time.perf_counter()
                vals, ids = self.index.search(batch.queries, k, **kwargs)
                vals, ids = to_host(vals), to_host(ids)         # blocks
                done = time.perf_counter()
                for obs in observers:
                    obs.observe(batch.queries[:batch.n_valid],
                                ids[:batch.n_valid], k)
                finished: list[int] = []
                for s in batch.slices:
                    rid, rows = s.request_id, s.stop - s.start
                    if out_scores[rid].shape[1] == 0:
                        k_out = vals.shape[1]
                        out_scores[rid] = np.empty(
                            (out_scores[rid].shape[0], k_out), np.float32)
                        out_ids[rid] = np.empty(
                            (out_ids[rid].shape[0], k_out), np.int32)
                    out_scores[rid][s.req_start: s.req_start + rows] = \
                        vals[s.start: s.stop]
                    out_ids[rid][s.req_start: s.req_start + rows] = \
                        ids[s.start: s.stop]
                    rows_left[rid] -= rows
                    if rows_left[rid] == 0:
                        finished.append(rid)
                for rid in finished:
                    results[rid] = ServeResult(
                        request_id=rid, scores=out_scores[rid],
                        ids=out_ids[rid],
                        latency_s=done - submit_time[rid])
                with self._lock:
                    self.latency.record(done - t0)
                    self.batches_served += 1
                    self.queries_served += batch.n_valid
                    self.requests_served += len(finished)
                    self._inflight_requests -= len(finished)
                    for rid in finished:
                        self._inflight_rows -= out_ids[rid].shape[0]
                        self.request_latency.record(results[rid].latency_s)
        return results

    # -- observability -----------------------------------------------------
    def stats(self) -> dict:
        """Lock-consistent snapshot: every counter is read under the same
        lock drain/submit mutate them under, so
        ``requests_submitted == requests_served + pending_requests +
        inflight_requests`` holds on *every* snapshot, not just at
        quiesce.  Latency keys (``count``/``p50_ms``/…) are the per-batch
        device time; ``request_*`` keys are per-request queue-entry →
        last-batch-done."""
        with self._lock:
            s = {"requests_served": self.requests_served,
                 "queries_served": self.queries_served,
                 "batches_served": self.batches_served,
                 "requests_submitted": self.requests_submitted,
                 "queries_submitted": self.queries_submitted,
                 "pending_requests": len(self._pending),
                 "pending_rows": sum(q.shape[0]
                                     for _, q, _, _ in self._pending),
                 "inflight_requests": self._inflight_requests,
                 "inflight_rows": self._inflight_rows,
                 **self.latency.summary()}
            s.update({f"request_{key}": val for key, val
                      in self.request_latency.summary().items()})
        if self.shadow is not None:
            s["shadow_overlap"] = self.shadow.mean_overlap
            s["shadow_batches"] = len(self.shadow.overlaps)
        return s
