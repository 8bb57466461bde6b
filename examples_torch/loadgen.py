"""Open-loop load generation against the port's ``RetrievalService``.

A copy, over numpy and :mod:`repro_torch.serve`, of the pieces of
``benchmarks/loadgen.py`` that ``examples_torch/serve_compressed.py``'s
tiered act drives: the request menu, the pre-drawn Zipf-skewed Poisson
workload, the warm-up and one open-loop trial.  The bursty arrival
process, the mutator thread, the cache identity check and the sweep are
not copied.  The port's benchmark may move this module.

Open loop: an arrival schedule is drawn up front, the submitter fires each
request at its scheduled instant whether or not earlier ones came back,
and a request's latency runs from its *scheduled* arrival to the moment
its last micro-batch completes (``ServeResult.latency_s`` plus any
submitter lag), so queueing under overload is measured, not hidden.
"""

import dataclasses
import time
from typing import Optional

import numpy as np

from repro_torch.serve import QueryOptions, QueueFull, RateLimited


@dataclasses.dataclass(frozen=True)
class MenuItem:
    """One request shape: how many rows, search width, rate-limit lane."""

    weight: float
    rows: int
    k: int
    nprobe: Optional[int]
    lane: str


DEFAULT_MENU = (
    MenuItem(0.55, 1, 10, 4, "interactive"),    # hot path: 1-row, fast probe
    MenuItem(0.25, 4, 10, 8, "interactive"),    # small block, default probe
    MenuItem(0.15, 16, 20, 8, "bulk"),          # bulk scoring block
    MenuItem(0.05, 32, 20, 16, "bulk"),         # recall-heavy bulk block
)


@dataclasses.dataclass
class Workload:
    """A fully pre-drawn trial: no randomness left on the hot path."""

    arrivals: np.ndarray          # (n,) seconds from trial start, sorted
    menu_ids: np.ndarray          # (n,) index into menu
    row_ids: list                 # per request: pool indices, len = rows
    offered_rows_per_s: float


def zipf_weights(n: int, alpha: float) -> np.ndarray:
    w = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** alpha
    return w / w.sum()


def build_workload(rng, *, duration_s: float, rows_per_s: float, menu,
                   pool_size: int, zipf_alpha: float) -> Workload:
    """Draw the Poisson arrival schedule + per-request shapes for one trial.

    ``rows_per_s`` is the offered rate in query *rows*; the request rate
    follows from the menu's mean rows/request, and inter-arrivals are
    exponential.  The draws are ``benchmarks/loadgen.py``'s for
    ``arrival="poisson"``, in its order, so the schedule is byte-equal.
    """
    weights = np.asarray([m.weight for m in menu], np.float64)
    weights = weights / weights.sum()
    mean_rows = float(sum(w * m.rows for w, m in zip(weights, menu)))
    req_rate = rows_per_s / mean_rows
    n = max(1, int(round(req_rate * duration_s)))
    arrivals = np.cumsum(rng.exponential(1.0 / req_rate, size=n))
    menu_ids = rng.choice(len(menu), size=n, p=weights)
    pool_p = zipf_weights(pool_size, zipf_alpha)
    row_ids = [rng.choice(pool_size, size=menu[m].rows, p=pool_p)
               for m in menu_ids]
    return Workload(arrivals=arrivals, menu_ids=menu_ids, row_ids=row_ids,
                    offered_rows_per_s=rows_per_s)


def warmup(service, name: str, pool: np.ndarray, menu,
           max_batch: int, timeout_s: float) -> None:
    """Run the search shapes the trial will hit before the clock starts:
    one block per menu shape and power-of-two row bucket up to
    ``max_batch``.  A cold server pays first calls once at startup, not per
    request — measuring them inside the trial would charge steady-state
    latency for a one-time cost."""
    sizes, rows = set(), 1
    while rows <= max_batch:            # every pow2 bucket the batcher forms
        sizes.add(rows)
        rows *= 2
    for item in menu:
        for rows in sorted(sizes):
            q = pool[np.arange(rows) % len(pool)]
            service.query(q, QueryOptions(index=name, k=item.k,
                                          nprobe=item.nprobe,
                                          lane=item.lane)) \
                .result(timeout=timeout_s)


def run_trial(service, name: str, pool: np.ndarray, menu,
              workload: Workload, *, timeout_s: float = 120.0) -> dict:
    """Fire one open-loop trial; returns the requests admitted and lost and
    the latency percentiles."""
    records = []          # (handle, scheduled_s, submitted_s)
    t0 = time.perf_counter()
    for i in range(len(workload.arrivals)):
        sched = workload.arrivals[i]
        lag = sched - (time.perf_counter() - t0)
        if lag > 0:
            time.sleep(lag)
        item = menu[workload.menu_ids[i]]
        q = pool[workload.row_ids[i]]
        submitted = time.perf_counter() - t0
        try:
            h = service.query(q, QueryOptions(index=name, k=item.k,
                                              nprobe=item.nprobe,
                                              lane=item.lane))
        except (RateLimited, QueueFull):    # shed at the door
            continue
        records.append((h, sched, submitted))

    # collect: latency runs from the *scheduled* arrival (anti-coordinated-
    # omission) to the request's last micro-batch completing
    lat, lost = [], 0
    for h, sched, submitted in records:
        try:
            res = h.result(timeout=timeout_s)
        except Exception:
            lost += 1
            continue
        lat.append((submitted - sched) + res.latency_s)

    ms = np.asarray(lat) * 1000.0 if lat else np.asarray([np.nan])
    return {
        "admitted": len(records),
        "lost": lost,
        "p50_ms": float(np.percentile(ms, 50)),
        "p99_ms": float(np.percentile(ms, 99)),
    }
