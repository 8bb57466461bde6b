"""Per-index token-bucket rate limiting with priority lanes.

Admission control (``max_pending_queries``) bounds how much work may
*queue*; it does nothing about who gets the capacity.  One misbehaving
bulk client can fill the queue faster than interactive users blink, and
every rejection is then distributed at random.  The limiter in front of
the queue fixes both:

* **Per-index token buckets** — each index gets a refill ``qps`` (query
  rows per second) and a ``burst`` (bucket capacity).  Traffic beyond the
  sustained rate is shed *at submit time* with
  :class:`~repro_torch.serve.service.RateLimited` — the caller sheds or backs
  off, the queue never absorbs the overload, and the p99 of admitted
  traffic stays bounded.
* **Priority lanes** — a request declares a lane
  (``QueryOptions(lane="bulk")``); lanes listed in the policy are capped
  at a *fraction* of the index qps by their own bucket.  Uncapped lanes
  (the interactive default) only contend for the shared bucket, so when a
  capped bulk lane saturates, its excess is shed from the bulk lane alone
  and interactive traffic keeps its full share — the standard
  guaranteed-share serving contract.

Tokens are rows, not requests: a 64-row block costs 64× what a 1-row
interactive lookup costs, which is what the device actually sees.

The clock is injectable (``clock=...``) so policies are unit-testable
without sleeping; everything is thread-safe.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional


class TokenBucket:
    """Classic token bucket: ``rate`` tokens/s refill, ``burst`` capacity.

    ``try_acquire(n)`` is all-or-nothing: it refills by elapsed wall time,
    then either takes ``n`` tokens or leaves the bucket untouched.
    """

    def __init__(self, rate: float, burst: float,
                 clock: Callable[[], float] = time.monotonic):
        if rate <= 0:
            raise ValueError(f"rate must be > 0, got {rate}")
        if burst <= 0:
            raise ValueError(f"burst must be > 0, got {burst}")
        self.rate = float(rate)
        self.burst = float(burst)
        self._clock = clock
        self._tokens = float(burst)            # start full: allow a burst
        self._stamp = clock()
        self._mu = threading.Lock()

    def _refill_locked(self) -> None:
        now = self._clock()
        self._tokens = min(self.burst,
                           self._tokens + (now - self._stamp) * self.rate)
        self._stamp = now

    def try_acquire(self, n: float = 1.0) -> bool:
        with self._mu:
            self._refill_locked()
            if self._tokens >= n:
                self._tokens -= n
                return True
            return False

    def refund(self, n: float) -> None:
        """Return tokens taken by a two-phase acquire that then failed its
        second bucket (never refill past ``burst``)."""
        with self._mu:
            self._tokens = min(self.burst, self._tokens + n)

    @property
    def available(self) -> float:
        with self._mu:
            self._refill_locked()
            return self._tokens


class _IndexPolicy:
    """One index's buckets + shed counters."""

    def __init__(self, qps: float, burst: float,
                 lanes: dict[str, float], clock):
        self.qps = float(qps)
        self.burst = float(burst)
        self.shared = TokenBucket(qps, burst, clock=clock)
        self.lanes: dict[str, TokenBucket] = {}
        self.lane_fractions = dict(lanes)
        for lane, fraction in lanes.items():
            if not 0.0 < fraction <= 1.0:
                raise ValueError(f"lane {lane!r}: fraction must be in "
                                 f"(0, 1], got {fraction}")
            self.lanes[lane] = TokenBucket(qps * fraction,
                                           max(1.0, burst * fraction),
                                           clock=clock)
        self.allowed = 0
        self.denied = 0
        self.denied_by_lane: dict[str, int] = {}
        self.mu = threading.Lock()

    def allow(self, lane: str, rows: int) -> bool:
        # lane cap first: a capped lane over its share must not drain the
        # shared bucket and starve the uncapped (priority) lanes
        lane_bucket = self.lanes.get(lane)
        if lane_bucket is not None and not lane_bucket.try_acquire(rows):
            ok = False
        elif self.shared.try_acquire(rows):
            ok = True
        else:
            if lane_bucket is not None:        # two-phase: undo the lane take
                lane_bucket.refund(rows)
            ok = False
        with self.mu:
            if ok:
                self.allowed += rows
            else:
                self.denied += rows
                self.denied_by_lane[lane] = \
                    self.denied_by_lane.get(lane, 0) + rows
        return ok

    def stats(self) -> dict:
        with self.mu:
            return {
                "qps": self.qps, "burst": self.burst,
                "lanes": dict(self.lane_fractions),
                "rows_allowed": self.allowed,
                "rows_denied": self.denied,
                "denied_by_lane": dict(self.denied_by_lane),
                "tokens_available": self.shared.available,
            }


class RateLimiter:
    """Name → policy map the service consults before admission.

    Indexes without a configured policy are unlimited.  ``configure`` may
    be called at any time (including while serving) — the new policy
    replaces the old one atomically with fresh, full buckets.
    """

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self._policies: dict[str, _IndexPolicy] = {}
        self._mu = threading.Lock()

    def configure(self, index: str, *, qps: float,
                  burst: Optional[float] = None,
                  lanes: Optional[dict[str, float]] = None) -> None:
        """Set/replace the policy for ``index``: sustained ``qps`` (query
        rows/s), ``burst`` capacity (default one second of qps), and
        ``lanes`` mapping lane name → fraction of qps that lane may use.
        """
        policy = _IndexPolicy(qps, qps if burst is None else burst,
                              lanes or {}, self._clock)
        with self._mu:
            self._policies[index] = policy

    def remove(self, index: str) -> bool:
        with self._mu:
            return self._policies.pop(index, None) is not None

    def allow(self, index: str, lane: str, rows: int) -> bool:
        with self._mu:
            policy = self._policies.get(index)
        if policy is None:
            return True
        return policy.allow(lane, rows)

    def stats(self) -> dict[str, dict]:
        with self._mu:
            policies = dict(self._policies)
        return {name: p.stats() for name, p in policies.items()}

    def __contains__(self, index: str) -> bool:
        with self._mu:
            return index in self._policies
