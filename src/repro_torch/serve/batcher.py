"""Micro-batching: coalesce queued query requests into padded batches.

Requests arrive with arbitrary row counts (1 query from an interactive user,
hundreds from a batch client).  The batcher flattens the pending queue in
FIFO order, slices it into micro-batches of at most ``max_batch`` rows, and
pads each batch's row count up to a power-of-two bucket, so the search sees
O(log max_batch) distinct shapes instead of one per request size (in
``repro`` that bounds jit recompiles; the port keeps the same batches, so
both packages serve the same padded shapes).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Slice:
    """Rows ``batch[start:stop]`` answer request ``request_id`` rows
    ``req_start:req_start + (stop - start)``."""

    request_id: int
    start: int
    stop: int
    req_start: int


@dataclasses.dataclass(frozen=True)
class MicroBatch:
    queries: np.ndarray          # (padded_rows, d); rows ≥ n_valid are pad
    n_valid: int
    slices: tuple[Slice, ...]


def bucket_rows(n: int, max_batch: int) -> int:
    """Smallest power-of-two ≥ n, capped at ``max_batch``."""
    b = 1
    while b < n:
        b *= 2
    return min(b, max_batch)


class MicroBatcher:
    """Stateless batch former: (pending requests) → list of MicroBatch."""

    def __init__(self, max_batch: int = 64, pad_batches: bool = True):
        if max_batch < 1:
            raise ValueError("max_batch must be ≥ 1")
        self.max_batch = max_batch
        self.pad_batches = pad_batches

    @property
    def batch_cap(self) -> int:
        """Effective row cap per micro-batch for the next ``form`` call
        (constant here; :class:`AdaptiveBatcher` moves it with load)."""
        return self.max_batch

    def form(self, pending: list[tuple[int, np.ndarray]]) -> list[MicroBatch]:
        """``pending`` is FIFO [(request_id, queries (n, d))] → micro-batches."""
        cap = self.batch_cap
        batches: list[MicroBatch] = []
        cur_rows: list[np.ndarray] = []
        cur_slices: list[Slice] = []
        cur_n = 0

        def flush():
            nonlocal cur_rows, cur_slices, cur_n
            if not cur_n:
                return
            q = np.concatenate(cur_rows, axis=0)
            if self.pad_batches:
                target = bucket_rows(cur_n, cap)
                if target > cur_n:
                    pad = np.zeros((target - cur_n,) + q.shape[1:], q.dtype)
                    q = np.concatenate([q, pad], axis=0)
            batches.append(MicroBatch(queries=q, n_valid=cur_n,
                                      slices=tuple(cur_slices)))
            cur_rows, cur_slices, cur_n = [], [], 0

        for request_id, queries in pending:
            queries = np.asarray(queries)
            if queries.ndim == 1:
                queries = queries[None, :]
            if queries.shape[0] == 0:
                # a 0-row entry would fall through the slicing loop without
                # producing a slice — the request would silently vanish
                raise ValueError(f"request {request_id}: empty query block")
            off = 0
            while off < queries.shape[0]:
                room = cap - cur_n
                take = min(room, queries.shape[0] - off)
                cur_rows.append(queries[off: off + take])
                cur_slices.append(Slice(request_id, cur_n, cur_n + take, off))
                cur_n += take
                off += take
                if cur_n == cap:
                    flush()
        flush()
        return batches


class AdaptiveBatcher(MicroBatcher):
    """Micro-batch sizing that follows queue depth.

    A fixed ``max_batch`` is the wrong trade at both ends of the load
    curve: shallow queues want small batches (a 4-row burst padded into a
    wider bucket wastes device compute for no coalescing win) and
    saturated queues want the widest batch the device can take (fewer
    dispatches per row is exactly where the throughput comes from).  The
    engine reports the rows it just popped via :meth:`observe_depth`
    before forming batches; the effective cap is that depth rounded up to
    a power of two and clamped to ``[min_batch, max_batch]``, so batch
    shapes stay the usual O(log) bucket set.

    State is one integer; the engines of a service share one batcher and
    a single dispatcher thread drains them in turn, so the cap each drain
    observes is its own queue's depth.
    """

    def __init__(self, min_batch: int = 8, max_batch: int = 256,
                 pad_batches: bool = True):
        if min_batch < 1 or min_batch > max_batch:
            raise ValueError(f"need 1 ≤ min_batch ≤ max_batch, got "
                             f"{min_batch}/{max_batch}")
        super().__init__(max_batch=max_batch, pad_batches=pad_batches)
        self.min_batch = min_batch
        self._cap = min_batch

    def observe_depth(self, rows_pending: int) -> int:
        """Adapt the cap to the rows just popped; returns the new cap."""
        target = bucket_rows(max(int(rows_pending), 1), self.max_batch)
        self._cap = min(max(target, self.min_batch), self.max_batch)
        return self._cap

    @property
    def batch_cap(self) -> int:
        return self._cap
