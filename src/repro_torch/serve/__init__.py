"""Online serving layer: a multi-index front door over micro-batching
execution cores.

Counterpart of ``repro.serve`` over the port's indexes, with the same
locks, counters and stats shape.  Results reach the host as numpy arrays
in one place (:meth:`ServeEngine.drain`); sharded placement
(``mesh=``/``shard=``) waits for the sharding slice of the port and
raises ``NotImplementedError``.

* :class:`~repro_torch.serve.service.RetrievalService` — the front door: a
  registry of named, versioned indexes (in-memory or lazily loaded from
  saved artifacts), an async ``query() → QueryHandle`` API served by a
  background drain-loop thread with admission control, and zero-downtime
  ``stage`` / canary / ``promote`` / ``rollback`` hot-swap.
* :class:`~repro_torch.serve.engine.ServeEngine` — the per-index execution
  core: ``submit``/``drain`` request queue dispatching micro-batches to
  any index (dense / compressed / IVF, resident or tiered), latency percentiles,
  per-request ``k`` / ``nprobe`` overrides.
* :class:`~repro_torch.serve.batcher.MicroBatcher` — coalesces queued requests
  into padded micro-batches (power-of-two row buckets).
* :class:`~repro_torch.serve.shadow.ShadowScorer` — online quality validation
  against a reference index on a sampled fraction of traffic (also the
  hot-swap canary mechanism).
* :class:`~repro_torch.serve.metrics.LatencyStats` — streaming latency
  percentile tracking, mergeable across engines for the service snapshot.
* :class:`~repro_torch.serve.limits.RateLimiter` — per-index token-bucket rate
  limiting with priority lanes, consulted before admission
  (:class:`~repro_torch.serve.service.RateLimited` is the shed signal).
* :class:`~repro_torch.serve.cache.ResultCache` — hot-query result cache keyed
  on (index, epoch, version, k, nprobe, query-hash); epoch-keyed
  invalidation on live updates / compaction / promote.
* :class:`~repro_torch.serve.batcher.AdaptiveBatcher` — queue-depth-driven
  micro-batch sizing (small batches at low load, wide at saturation).
"""

from repro_torch.serve.batcher import AdaptiveBatcher, MicroBatch, MicroBatcher
from repro_torch.serve.cache import ResultCache
from repro_torch.serve.engine import ServeEngine, ServeResult
from repro_torch.serve.limits import RateLimiter, TokenBucket
from repro_torch.serve.metrics import LatencyStats
from repro_torch.serve.router import (IndexEntry, IndexRegistry, IndexVersion,
                                load_engine)
from repro_torch.serve.service import (CanaryFailed, QueryHandle, QueryOptions,
                                 QueueFull, RateLimited, RetrievalService,
                                 ServiceClosed)
from repro_torch.serve.shadow import ShadowScorer
from repro_torch.serve.stats import (IndexStats, ServiceStats, ShardStats,
                               VersionStats)

__all__ = [
    "AdaptiveBatcher", "MicroBatch", "MicroBatcher",
    "ServeEngine", "ServeResult", "load_engine",
    "LatencyStats", "ShadowScorer",
    "RateLimiter", "TokenBucket", "ResultCache",
    "IndexEntry", "IndexRegistry", "IndexVersion",
    "RetrievalService", "QueryOptions", "QueryHandle",
    "QueueFull", "RateLimited", "CanaryFailed", "ServiceClosed",
    "ServiceStats", "IndexStats", "VersionStats", "ShardStats",
]
