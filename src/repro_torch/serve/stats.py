"""Typed stats schema for :meth:`RetrievalService.stats`.

The ad-hoc nested dict the service grew across PRs 4–8 is now documented
as dataclasses — one schema that replint's lock pass, the benchmarks,
and dashboards all read.  ``RetrievalService.stats()`` keeps returning
the same plain-dict shape (``ServiceStats.to_dict()`` reproduces it
key-for-key), while ``RetrievalService.stats_typed()`` returns this
structure for callers that want attributes instead of string keys.

The per-shard rollup is new in this schema: a version serving a sharded
index (or a mutable index over a sharded main) carries a ``shards`` list
— docs/lists owned per shard under the greedy partition, plus how many
live delta rows would fold into each shard's lists.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class ShardStats:
    """One doc shard's slice of a sharded version.

    ``n_lists`` is None for flat (non-IVF) sharded storage; ``n_delta``
    is None for immutable versions (no delta layer to roll up).
    """

    shard: int
    n_docs: int
    n_lists: Optional[int] = None
    n_delta: Optional[int] = None

    @classmethod
    def from_dict(cls, d: dict) -> "ShardStats":
        return cls(shard=int(d["shard"]), n_docs=int(d["n_docs"]),
                   n_lists=d.get("n_lists"), n_delta=d.get("n_delta"))

    def to_dict(self) -> dict:
        out = {"shard": self.shard, "n_docs": self.n_docs}
        if self.n_lists is not None:
            out["n_lists"] = self.n_lists
        if self.n_delta is not None:
            out["n_delta"] = self.n_delta
        return out


@dataclasses.dataclass
class VersionStats:
    """One index version's row in the service stats table.

    ``info`` is the registration-time identity (source, kind, n_docs,
    spec fingerprint…); ``engine`` the execution-core counters and
    latency summary (:meth:`repro_torch.serve.engine.ServeEngine.stats`) when
    the version is loaded; ``mutable`` the delta/tombstone/drift snapshot
    for :class:`~repro_torch.retrieval.segments.SegmentedIndex` versions;
    ``tier`` the hot/cold store gauges for partially resident (v3
    chunked) versions; ``shards`` the per-shard rollup for versions
    serving a sharded index.
    """

    info: dict
    loaded: bool
    engine: dict = dataclasses.field(default_factory=dict)
    mutable: Optional[dict] = None
    tier: Optional[dict] = None
    shards: Optional[list] = None          # list[ShardStats]

    def to_dict(self) -> dict:
        row = dict(self.info)
        row["loaded"] = self.loaded
        row.update(self.engine)
        if self.mutable is not None:
            row["mutable"] = self.mutable
        if self.tier is not None:
            row["tier"] = self.tier
        if self.shards is not None:
            row["shards"] = [s.to_dict() for s in self.shards]
        return row


@dataclasses.dataclass
class IndexStats:
    """One named index: pointer triple + version table + carry-overs."""

    live: Optional[int]
    staged: Optional[int]
    previous: Optional[int]
    canary: Optional[dict]
    versions: dict                          # vid -> VersionStats
    retired: dict

    def to_dict(self) -> dict:
        return {"live": self.live, "staged": self.staged,
                "previous": self.previous, "canary": self.canary,
                "versions": {vid: v.to_dict()
                             for vid, v in self.versions.items()},
                "retired": self.retired}


@dataclasses.dataclass
class ServiceStats:
    """The full service snapshot :meth:`RetrievalService.stats_typed`
    returns.

    ``latency`` is the merged per-batch device-time summary;
    ``request_latency`` the per-request queue-entry → last-batch-done
    summary (the SLO numbers).  ``to_dict()`` flattens both into the
    historical top-level keys (``p50_ms``…, ``request_p50_ms``…) so
    existing readers keep working unchanged.
    """

    indexes: dict                           # name -> IndexStats
    pending_queries: int
    queue_depth: int
    queue_high_water: int
    requests_admitted: int
    requests_rejected: int
    requests_rate_limited: int
    shed_rate: float
    cache_hits: int
    updates_applied: int
    compactions_run: int
    totals: dict
    latency: dict
    request_latency: dict
    cache: Optional[dict] = None
    limits: Optional[dict] = None

    def to_dict(self) -> dict:
        out = {"indexes": {name: ix.to_dict()
                           for name, ix in self.indexes.items()},
               "pending_queries": self.pending_queries,
               "queue_depth": self.queue_depth,
               "queue_high_water": self.queue_high_water,
               "requests_admitted": self.requests_admitted,
               "requests_rejected": self.requests_rejected,
               "requests_rate_limited": self.requests_rate_limited,
               "shed_rate": self.shed_rate,
               "cache_hits": self.cache_hits,
               "updates_applied": self.updates_applied,
               "compactions_run": self.compactions_run,
               **self.totals,
               **self.latency}
        out.update({f"request_{key}": val
                    for key, val in self.request_latency.items()})
        if self.cache is not None:
            out["cache"] = self.cache
        if self.limits:
            out["limits"] = self.limits
        return out
