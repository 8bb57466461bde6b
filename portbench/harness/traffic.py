"""The one traffic generator: it reads a mix's data file and drives the
program through it.

``"loop": "closed"`` — one client: a batch of ``batch`` queries at depth
``k`` through the index's ``search``; the ids and scores reach the host
before the next batch is sent.  Batches walk a pool of ``pool`` queries
drawn at set-up.  End-to-end metric: ``qps``, every query completed in
the window over the window's length.

``"loop": "open"`` — Poisson arrivals at ``rows_per_s`` offered query
rows a second, each request a draw from ``menu`` (rows and k), its rows
drawn from the pool, sent at its scheduled instant through
``RetrievalService.query`` whether or not earlier ones came back.  A
request's latency runs from its scheduled send to its result on the
host; a refused request counts as failed and enters the tail as +inf.
End-to-end metrics: ``p50_ms`` and ``p95_ms`` over every request of the
window.  The schedule's draws are ``examples_torch/loadgen.py``'s
``build_workload`` (itself ``benchmarks/loadgen.py``'s), in its order.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from portbench.harness import program
from portbench.harness.stats import percentile


@dataclasses.dataclass
class Window:
    """What one measured window gives the rest of the run."""
    seconds: float
    attempted: int
    failed: int
    metrics: dict                 # end-to-end values by name
    spans: dict                   # harness span name → host seconds each
    counters: dict                # counter deltas over the window
    send_lags: list
    rows: np.ndarray              # pool rows whose answers are checked
    ks: list
    scores: list
    ids: list
    calls: list                   # traced calls: {"rows": pool rows, "k"}
    lost: int = 0


def schedule(traffic: dict, seconds: float, rng: np.random.Generator):
    """(arrivals s, menu ids, row ids) of an open-loop window: exponential
    inter-arrivals at the request rate the offered row rate gives, drawn
    as ``loadgen.build_workload`` draws them."""
    menu = traffic["menu"]
    weights = np.asarray([m["weight"] for m in menu], np.float64)
    weights = weights / weights.sum()
    mean_rows = float(sum(w * m["rows"] for w, m in zip(weights, menu)))
    req_rate = float(traffic["rows_per_s"]) / mean_rows
    n = max(1, int(round(req_rate * seconds)))
    arrivals = np.cumsum(rng.exponential(1.0 / req_rate, size=n))
    menu_ids = rng.choice(len(menu), size=n, p=weights)
    pool = int(traffic["pool"])
    alpha = float(traffic.get("zipf_alpha", 0.0))
    pool_p = 1.0 / np.arange(1, pool + 1, dtype=np.float64) ** alpha
    pool_p = pool_p / pool_p.sum()
    row_ids = [rng.choice(pool, size=menu[m]["rows"], p=pool_p)
               for m in menu_ids]
    return arrivals, menu_ids, row_ids


class ClosedLoop:
    def __init__(self, index, pool: torch.Tensor, traffic: dict, tracer):
        self.index, self.traffic, self.tracer = index, traffic, tracer
        self.b, self.k = int(traffic["batch"]), int(traffic["k"])
        n = pool.shape[0] // self.b
        self.batches = [pool[i * self.b:(i + 1) * self.b] for i in range(n)]

    def _one(self, i: int):
        tr = self.tracer
        t0 = time.perf_counter()
        with tr.span("search"):
            vals, ids = self.index.search(self.batches[i], self.k)
        t1 = time.perf_counter()
        with tr.span("to_host"):
            v, d = vals.cpu().numpy(), ids.cpu().numpy()
        return v, d, t0, t1, time.perf_counter()

    def warmup(self) -> None:
        for i in range(min(2, len(self.batches))):
            self._one(i)

    def run(self, seconds: float, rng: np.random.Generator) -> Window:
        nb = len(self.batches)
        last, host, lat, calls = {}, [], [], []
        self.tracer.start()
        start = time.perf_counter()
        i = 0
        while True:
            v, d, t0, t1, t2 = self._one(i % nb)
            last[i % nb] = (v, d)
            host.append(t1 - t0)
            lat.append(t2 - t0)
            if self.tracer.active:
                calls.append({"rows": (i % nb) * self.b, "n": self.b,
                              "k": self.k})
            i += 1
            if t2 - start >= seconds:
                break
        window = t2 - start
        self.tracer.stop()
        n_q = i * self.b
        answered = np.concatenate([np.arange(j * self.b, (j + 1) * self.b)
                                   for j in sorted(last)])
        rows = np.sort(rng.choice(answered, size=min(int(
            self.traffic["check_queries"]), answered.size), replace=False))
        scores = [last[r // self.b][0][r % self.b] for r in rows]
        ids = [last[r // self.b][1][r % self.b] for r in rows]
        return Window(seconds=window, attempted=n_q, failed=0,
                      metrics={"qps": n_q / window},
                      spans={"search.host": host, "bulk.batch": lat},
                      counters={}, send_lags=[], rows=rows,
                      ks=[self.k] * len(rows), scores=scores, ids=ids,
                      calls=calls)


class OpenLoop:
    def __init__(self, index, pool: torch.Tensor, traffic: dict, tracer):
        self.traffic, self.tracer = traffic, tracer
        self.pool = pool.cpu().numpy()
        self.svc = program.service(index, traffic)
        self.refused = program.refusals()
        self.options = {m["k"]: program.query_options(m["k"])
                        for m in traffic["menu"]}

    def warmup(self) -> None:
        """Every micro-batch shape the window can form: each k of the menu
        at each power-of-two row bucket up to ``max_batch``."""
        rows = 1
        while rows <= int(self.traffic["max_batch"]):
            for opt in self.options.values():
                self.svc.query(self.pool[:rows], opt).result(timeout=120)
            rows *= 2

    def close(self) -> None:
        self.svc.close()

    def run(self, seconds: float, rng: np.random.Generator) -> Window:
        tr, menu = self.tracer, self.traffic["menu"]
        arrivals, menu_ids, row_ids = schedule(self.traffic, seconds, rng)
        trace_at = seconds * float(self.traffic.get("trace_from", 0.4))
        trace_to = trace_at + float(self.traffic.get("trace_seconds",
                                                     seconds))
        before = program.served_totals(self.svc)
        sent = np.zeros(len(arrivals))
        handles = [None] * len(arrivals)
        refused = 0
        t0 = time.perf_counter()
        for i, sched in enumerate(arrivals):
            now = time.perf_counter() - t0
            if tr.on and not tr.active and not tr.done and now >= trace_at:
                tr.start()
            elif tr.active and now >= trace_to:
                tr.stop()
            while now < sched:
                time.sleep(min(sched - now, 0.001))
                now = time.perf_counter() - t0
            sent[i] = now
            item = menu[menu_ids[i]]
            try:
                with tr.span("submit"):
                    handles[i] = self.svc.query(self.pool[row_ids[i]],
                                                self.options[item["k"]])
            except self.refused:
                refused += 1
        window = time.perf_counter() - t0
        lat = np.full(len(arrivals), np.inf)
        results, lost = {}, 0
        deadline = time.perf_counter() + float(
            self.traffic.get("drain_timeout_s", 60))
        for i, h in enumerate(handles):
            if h is None:
                continue
            try:
                res = h.result(timeout=max(deadline - time.perf_counter(),
                                           0.001))
            except Exception:   # a request that never came back
                lost += 1
                continue
            lat[i] = (sent[i] - arrivals[i]) + res.latency_s
            results[i] = res
        if tr.active:
            tr.stop()
        after = program.served_totals(self.svc)
        done = np.fromiter(results, dtype=np.int64)
        n_check = min(int(self.traffic["check_requests"]), done.size)
        pick = set(rng.choice(done, size=n_check, replace=False).tolist())
        if done.size:   # the longest request is always among them
            pick.add(int(max(done, key=lambda j: len(row_ids[j]))))
        rows, ks, scores, ids = [], [], [], []
        for j in sorted(pick):
            k = menu[menu_ids[j]]["k"]
            for r, pool_row in enumerate(row_ids[j]):
                rows.append(int(pool_row))
                ks.append(k)
                scores.append(results[j].scores[r])
                ids.append(results[j].ids[r])
        ms = lat * 1000.0
        return Window(
            seconds=window, attempted=len(arrivals), failed=refused + lost,
            metrics={"p50_ms": percentile(ms, 50),
                     "p95_ms": percentile(ms, 95)},
            spans={}, counters={k: after[k] - before[k] for k in after},
            send_lags=list(sent - arrivals), rows=np.asarray(rows),
            ks=ks, scores=scores, ids=ids, calls=[], lost=lost)


def driver(index, pool: torch.Tensor, traffic: dict, tracer):
    loops = {"closed": ClosedLoop, "open": OpenLoop}
    return loops[traffic["loop"]](index, pool, traffic, tracer)
