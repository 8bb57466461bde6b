"""Fault-tolerance machinery: preemption capture, retries, straggler watch.

On a real multi-pod deployment each host runs this; here everything is
exercised single-host (tests simulate signals/stragglers).  The pieces:

- :class:`PreemptionHandler` — catches SIGTERM/SIGINT, flips a flag the train
  loop polls; the loop saves an emergency checkpoint and exits cleanly
  (maps to Borg/GCE preemption notice or k8s SIGTERM grace period).
- :func:`with_retries` — deterministic-backoff retry wrapper for transient
  infra faults (checkpoint I/O, RPC); *compute* errors are not retried.
- :class:`StragglerMonitor` — per-step wall-time EWMA; a step slower than
  ``threshold ×`` the EWMA flags its host as a straggler.  At fleet scale the
  controller reacts by excluding the host and re-meshing
  (``train/elastic.py``, still to port); here we log + count.
"""

from __future__ import annotations

import signal
import threading
import time
from typing import Callable, Optional, TypeVar

T = TypeVar("T")


class PreemptionHandler:
    def __init__(self, signals=(signal.SIGTERM,)):
        self._stop = threading.Event()
        self._installed = []
        for sig in signals:
            prev = signal.signal(sig, self._handle)
            self._installed.append((sig, prev))

    def _handle(self, signum, frame):
        self._stop.set()

    def should_stop(self) -> bool:
        return self._stop.is_set()

    def trigger(self) -> None:          # for tests
        self._stop.set()

    def uninstall(self) -> None:
        for sig, prev in self._installed:
            signal.signal(sig, prev)
        self._installed.clear()


def with_retries(fn: Callable[..., T], *args, retries: int = 3,
                 backoff: float = 0.5,
                 retry_on: tuple = (IOError, OSError),
                 log_fn=print, **kwargs) -> T:
    last: Optional[BaseException] = None
    for attempt in range(retries + 1):
        try:
            return fn(*args, **kwargs)
        except retry_on as e:           # transient infra faults only
            last = e
            if attempt < retries:
                delay = backoff * (2 ** attempt)
                log_fn(f"[retry] {fn.__name__} failed ({e}); "
                       f"attempt {attempt+1}/{retries} in {delay:.1f}s")
                time.sleep(delay)
    raise last  # type: ignore[misc]


class StragglerMonitor:
    """EWMA step-time monitor; flags steps slower than threshold × EWMA."""

    def __init__(self, threshold: float = 2.0, alpha: float = 0.2,
                 warmup_steps: int = 3):
        self.threshold = threshold
        self.alpha = alpha
        self.warmup_steps = warmup_steps
        self.ewma: Optional[float] = None
        self.n = 0
        self.flagged: list[tuple[int, float]] = []
        self._t0: Optional[float] = None

    def start_step(self) -> None:
        self._t0 = time.monotonic()

    def end_step(self) -> bool:
        """Returns True if this step was a straggler."""
        assert self._t0 is not None
        dt = time.monotonic() - self._t0
        self.n += 1
        is_straggler = False
        if self.ewma is None:
            self.ewma = dt
        else:
            if (self.n > self.warmup_steps
                    and dt > self.threshold * self.ewma):
                self.flagged.append((self.n, dt))
                is_straggler = True
            else:
                self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        return is_straggler

    def observe(self, dt: float) -> bool:
        """Feed an externally-measured step time (tests)."""
        self._t0 = time.monotonic() - dt
        return self.end_step()
