"""Streaming serving metrics (host-side, numpy only)."""

from __future__ import annotations

import threading
from typing import Iterable

import numpy as np


class LatencyStats:
    """Collects latency samples; reports percentiles in milliseconds.

    Keeps a sliding window of the most recent ``window`` samples so a
    long-lived serving engine neither grows without bound nor pays
    O(uptime) per percentile query; ``count`` still reports the total
    recorded.

    Thread-safe: ``record`` may race ``summary``/``percentile``/``merge``
    from any number of reader threads (the service stats rollup reads
    every engine's collector while drains keep recording) — each call
    sees a consistent window.
    """

    def __init__(self, window: int = 8192) -> None:
        if window < 1:
            raise ValueError("window must be ≥ 1")
        self.window = window
        self.total_recorded = 0
        self._samples: list[float] = []
        self._mu = threading.Lock()

    def record(self, seconds: float) -> None:
        with self._mu:
            self._samples.append(float(seconds))
            self.total_recorded += 1
            if len(self._samples) > self.window:
                del self._samples[: len(self._samples) - self.window]

    def __len__(self) -> int:
        with self._mu:
            return self.total_recorded

    @property
    def samples(self) -> tuple[float, ...]:
        """Snapshot of the retained window, in seconds."""
        with self._mu:
            return tuple(self._samples)

    def _snapshot(self) -> tuple[int, tuple[float, ...]]:
        with self._mu:
            return self.total_recorded, tuple(self._samples)

    @classmethod
    def merge(cls, parts: Iterable["LatencyStats"]) -> "LatencyStats":
        """Roll several collectors into one (the service-level snapshot
        over per-engine collectors): retained windows concatenate, total
        counts sum.  The merged view is itself a :class:`LatencyStats`, so
        ``summary()`` / ``percentile()`` work unchanged."""
        parts = list(parts)
        merged = cls(window=max(1, sum(p.window for p in parts)))
        for p in parts:
            total, samples = p._snapshot()
            merged._samples.extend(samples)
            merged.total_recorded += total
        return merged

    def percentile(self, p: float) -> float:
        """p-th percentile latency in milliseconds (nan when empty)."""
        _, samples = self._snapshot()
        if not samples:
            return float("nan")
        return float(np.percentile(np.asarray(samples) * 1000.0, p))

    def summary(self) -> dict[str, float]:
        total, samples = self._snapshot()
        if not samples:
            return {"count": total, "mean_ms": float("nan"),
                    "p50_ms": float("nan"), "p95_ms": float("nan"),
                    "p99_ms": float("nan")}
        ms = np.asarray(samples) * 1000.0
        return {
            "count": total,
            "mean_ms": float(np.mean(ms)),
            "p50_ms": float(np.percentile(ms, 50)),
            "p95_ms": float(np.percentile(ms, 95)),
            "p99_ms": float(np.percentile(ms, 99)),
        }
