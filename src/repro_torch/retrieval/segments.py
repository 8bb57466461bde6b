"""Mutable indexes: delta segments + tombstones over a frozen main.

Counterpart of ``repro.retrieval.segments`` for a single-host main, fully
resident or store-backed (tiered).  :class:`SegmentedIndex` makes an index
mutable without re-fitting its compression pipeline:

* **Delta segments** — ``add(docs)`` encodes the new rows through the
  *frozen* fitted pipeline into an append-only segment, with the same
  encode a fresh build uses (:func:`~repro_torch.retrieval.scorers.
  encode_storage`: the one-pass ``fused_quantize`` kernel for the paper's
  pre+post-normalized 24× recipe on the card), and scores them with the
  same scorer, so a segmented search ranks as one index holding the same
  rows would.  The layers merge with the strict ``(score desc, id asc)``
  order (:func:`~repro_torch.retrieval.topk.masked_topk_by_id`).
* **Tombstones** — ``delete(ids)`` marks global doc ids dead; the main is
  probed ``k + #dead(main)`` deep so the surviving top-k is exactly that
  of a fresh build over the surviving corpus.
* **Global doc ids** — a monotonic allocator; ids survive compaction.
* **IVF mains** — added rows are routed to the existing centroids at
  ``add`` time and compete only when their list is probed.  Over a
  store-backed main the lists those rows route to are pinned in the hot
  tier.
* **Drift monitor** — running mean/norm statistics of added docs against
  the pipeline's fitted centering statistics feed
  :meth:`SegmentedIndex.needs_compaction`.
* **Compaction** — :meth:`SegmentedIndex.compact` folds the layers into a
  fresh main in memory (storage rows moved, never re-encoded; a resident
  IVF main refits only its router, a store-backed one keeps it) or, with
  ``out_path=``, list by list into a chunked v3 artifact, and returns a
  new index with the same ids.

Sharded mains wait for the sharding slice of the port.

Concurrency: ``add``/``delete`` swap an immutable snapshot under a lock;
``search`` reads one snapshot reference and never blocks.
"""

from __future__ import annotations

import threading
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.preprocess import as_tensor
from repro_torch.retrieval.index import CompressedIndex, DenseIndex
from repro_torch.retrieval.ivf import (IVFFlatIndex, IVFIndex, port_rows,
                                       route)
from repro_torch.retrieval.kmeans import assign
from repro_torch.retrieval.scorers import (Scorer, apply_float_stages,
                                           encode_storage)
from repro_torch.retrieval.topk import (NEG_INF, masked_topk_by_id, resolve_k,
                                        resolve_nprobe)
from repro_torch.utils import SHARD_SLICE

#: ``repro``'s sharded main kinds, which wait for the sharding slice
_SHARDED_KINDS = ("ShardedCompressedIndex", "ShardedIVFIndex")


def fitted_center_mean(pipeline) -> Optional[torch.Tensor]:
    """The doc-side mean (float64) of the pipeline's first fitted centering
    stage: what the drift monitor compares added docs against."""
    if pipeline is None:
        return None
    for t in getattr(pipeline, "transforms", []):
        if t.fitted and "mean_docs" in t.state:
            return t.state["mean_docs"].double()
    return None


class DriftMonitor:
    """Running mean/norm statistics of added docs vs. the fitted center.

    ``mean_shift`` is the L2 distance between the running mean of every
    doc added since the last compaction and the pipeline's fitted doc mean,
    over the mean row norm of the added docs: ~0 for additions from the
    fitted distribution, growing toward 1 as they drift.  The sums are
    float64 tensors on the docs' device.
    """

    def __init__(self, ref_mean=None):
        self.ref_mean = (as_tensor(ref_mean).double()
                         if ref_mean is not None else None)
        self.n_added = 0
        self._sum: Optional[torch.Tensor] = None
        self._norm_sum = 0.0

    def update(self, docs) -> None:
        x = as_tensor(docs).double()
        if x.ndim != 2 or x.shape[0] == 0:
            return
        s = x.sum(dim=0)
        self._sum = s if self._sum is None else self._sum + s.to(self._sum)
        self._norm_sum += float(torch.linalg.vector_norm(x, dim=1).sum())
        self.n_added += int(x.shape[0])

    @property
    def mean_shift(self) -> float:
        if self.n_added == 0:
            return 0.0
        mean = self._sum / self.n_added
        ref = (self.ref_mean.to(mean) if self.ref_mean is not None
               else torch.zeros_like(mean))
        scale = self._norm_sum / self.n_added + 1e-12
        return float(torch.linalg.vector_norm(mean - ref)) / scale

    def stats(self) -> dict:
        return {
            "n_added": self.n_added,
            "mean_norm": (self._norm_sum / self.n_added
                          if self.n_added else float("nan")),
            "ref_norm": (float(torch.linalg.vector_norm(self.ref_mean))
                         if self.ref_mean is not None else None),
            "mean_shift": self.mean_shift,
        }

    # -- persistence -------------------------------------------------------
    def state_dict(self) -> dict:
        return {"n_added": self.n_added, "sum": self._sum,
                "norm_sum": self._norm_sum}

    def load_state_dict(self, sd: dict) -> "DriftMonitor":
        self.n_added = int(sd["n_added"])
        self._sum = (as_tensor(sd["sum"]).double()
                     if sd.get("sum") is not None else None)
        if self._sum is not None and self.ref_mean is not None:
            self._sum = self._sum.to(self.ref_mean.device)
        self._norm_sum = float(sd["norm_sum"])
        return self


class _Segment:
    """One append-only delta: scorer-encoded rows + their global ids (and
    routed list labels for an IVF main)."""

    __slots__ = ("storage", "gids", "labels")

    def __init__(self, storage: torch.Tensor, gids: np.ndarray,
                 labels: Optional[np.ndarray]):
        self.storage = storage
        self.gids = gids
        self.labels = labels

    def __len__(self) -> int:
        return int(self.gids.shape[0])

    @property
    def nbytes(self) -> int:
        return self.storage.numel() * self.storage.element_size()


class _Snapshot:
    """Immutable view the search path binds to (mutations swap a new one);
    the device copies of the tombstones and of the concatenated delta are
    built once per snapshot."""

    __slots__ = ("segments", "tomb", "next_gid", "n_live", "n_main_dead",
                 "_delta", "_tomb_t")

    def __init__(self, segments: tuple, tomb: np.ndarray, next_gid: int,
                 n_live: int, n_main_dead: int):
        self.segments = segments
        self.tomb = tomb                    # bool over the whole gid space
        self.next_gid = next_gid
        self.n_live = n_live
        self.n_main_dead = n_main_dead
        self._delta = None
        self._tomb_t = None

    @property
    def n_delta(self) -> int:
        return sum(len(s) for s in self.segments)

    def tomb_t(self, device: torch.device) -> torch.Tensor:
        if self._tomb_t is None:
            self._tomb_t = torch.from_numpy(self.tomb).to(device)
        return self._tomb_t

    def delta(self, device: torch.device):
        """(storage, gids (np), gids (device, int64), labels (device,
        int64) | None) across all segments."""
        if self._delta is None:
            storage = torch.cat([s.storage for s in self.segments])
            gids = np.concatenate([s.gids for s in self.segments])
            labels = None
            if self.segments[0].labels is not None:
                labels = torch.from_numpy(np.concatenate(
                    [s.labels for s in self.segments])).to(device).long()
            self._delta = (storage, gids,
                           torch.from_numpy(gids).to(device).long(), labels)
        return self._delta


class SegmentedIndex:
    """Delta segments + tombstones layered over an immutable main index.

    ``main`` is a fitted :class:`DenseIndex`, :class:`CompressedIndex` or
    :class:`IVFIndex` / :class:`IVFFlatIndex` (resident or store-backed);
    its storage is adopted as the base layer and never touched again.
    Everything lives on the main's device.
    """

    def __init__(self, main, *, spec=None, drift_threshold: float = 0.35,
                 max_delta_fraction: float = 0.25):
        if isinstance(main, SegmentedIndex):
            raise TypeError("SegmentedIndex cannot wrap another "
                            "SegmentedIndex")
        if type(main).__name__ in _SHARDED_KINDS:
            raise NotImplementedError(
                f"SegmentedIndex over a sharded main waits for {SHARD_SLICE}")
        if not isinstance(main, (DenseIndex, CompressedIndex, IVFIndex)):
            raise TypeError(
                f"SegmentedIndex cannot wrap a {type(main).__name__} — "
                "mains are Dense/Compressed/IVF indexes")
        if len(main) == 0:
            raise ValueError("main index is empty — build it first")
        if getattr(main, "residual", False):
            raise TypeError(
                "SegmentedIndex cannot wrap a residual-encoded IVF main: "
                "delta rows are encoded without the routed-centroid "
                "subtraction, so cross-layer scores would not be "
                "comparable — build the main with residual=False")
        self.main = main
        self.device = main.device
        self.spec = getattr(main, "spec", None) if spec is None else spec
        self.sim = main.sim
        self.drift_threshold = float(drift_threshold)
        self.max_delta_fraction = float(max_delta_fraction)
        if isinstance(main, DenseIndex):
            self.float_stages: list = []
            self.scorer = Scorer(sim=main.sim, backend="torch")
            pipeline = None
        else:
            self.float_stages = main.float_stages
            self.scorer = main.scorer
            pipeline = main.pipeline
        self.drift = DriftMonitor(fitted_center_mean(pipeline))
        self._is_ivf = isinstance(main, IVFIndex)
        self._main_version = getattr(main, "_version", None)
        n_main = len(main)
        self._main_gids = np.arange(n_main, dtype=np.int32)
        self._main_gids_t: Optional[torch.Tensor] = None
        self._lock = threading.Lock()
        self._state = _Snapshot(segments=(), tomb=np.zeros(n_main, bool),
                                next_gid=n_main, n_live=n_main,
                                n_main_dead=0)

    # -- internal: adopt a post-compaction / loaded identity ---------------
    def _restore(self, *, main_gids: np.ndarray, tomb: np.ndarray,
                 next_gid: int, segments: tuple = (),
                 drift_sd: Optional[dict] = None) -> "SegmentedIndex":
        if len(main_gids) != len(self.main):
            raise ValueError(f"{len(main_gids)} main gids for a main of "
                             f"{len(self.main)} rows")
        self._main_gids = np.asarray(main_gids, np.int32)
        self._main_gids_t = None
        segments = tuple(segments)
        tomb = np.asarray(tomb, bool)
        n_main_dead = int(tomb[self._main_gids].sum())
        n_dead = n_main_dead + sum(int(tomb[s.gids].sum())
                                   for s in segments)
        n_delta = sum(len(s) for s in segments)
        self._state = _Snapshot(segments, tomb, int(next_gid),
                                len(self.main) + n_delta - n_dead,
                                n_main_dead)
        if drift_sd is not None:
            self.drift.load_state_dict(drift_sd)
        return self

    # -- sizing ------------------------------------------------------------
    def __len__(self) -> int:
        """Live (searchable) docs: main + deltas − tombstones."""
        return self._state.n_live

    @property
    def n_deltas(self) -> int:
        return self._state.n_delta

    @property
    def n_segments(self) -> int:
        return len(self._state.segments)

    @property
    def n_tombstoned(self) -> int:
        st = self._state
        return len(self.main) + st.n_delta - st.n_live

    @property
    def next_gid(self) -> int:
        return self._state.next_gid

    @property
    def nbytes(self) -> int:
        return self.main.nbytes + sum(s.nbytes for s in self._state.segments)

    @property
    def nprobe(self) -> Optional[int]:
        """Probe width of an IVF main (None otherwise)."""
        return self.main.nprobe if self._is_ivf else None

    # -- mutation ----------------------------------------------------------
    def add(self, docs) -> "SegmentedIndex":
        """Append docs as a new delta segment (frozen-pipeline encode).

        Rows get fresh global ids from the monotonic allocator; for IVF
        mains each row is routed to the existing centroids.
        """
        docs = as_tensor(docs, self.device)
        if docs.ndim != 2 or docs.shape[0] == 0:
            raise ValueError("add needs a (n ≥ 1, d) doc block, got shape "
                             f"{tuple(docs.shape)}")
        labels = None
        if self._is_ivf:
            # routing needs the float rows: the staged encode, as the
            # main's own build and add
            x = apply_float_stages(self.float_stages, docs, "docs")
            enc = self.scorer.encode_docs(x)
            labels = assign(x.float(), self.main.centroids) \
                .cpu().numpy().astype(np.int32)
        else:
            enc, _ = encode_storage(self.float_stages, self.scorer, docs)
        n = int(enc.shape[0])
        with self._lock:
            st = self._state
            gids = np.arange(st.next_gid, st.next_gid + n, dtype=np.int32)
            seg = _Segment(enc, gids, labels)
            tomb = np.concatenate([st.tomb, np.zeros(n, bool)])
            self.drift.update(docs)
            self._state = _Snapshot(st.segments + (seg,), tomb,
                                    st.next_gid + n, st.n_live + n,
                                    st.n_main_dead)
        store = getattr(self.main, "store", None)
        if labels is not None and store is not None:
            # a delta row competes whenever its routed list is probed — pin
            # those lists so merging main + delta never takes a cold miss
            store.pin(np.unique(labels).tolist())
        return self

    def validate_ids(self, ids: Sequence[int],
                     n_pending_add: int = 0) -> np.ndarray:
        """Normalise a delete-id list and bounds-check it, mutating nothing.

        Returns the unique sorted ids; raises ``KeyError`` for ids the
        allocator never handed out.  ``n_pending_add`` extends the bound
        over the ids a pending add block is about to be assigned.
        """
        ids = np.unique(np.asarray(ids, np.int64).ravel())
        bound = self._state.next_gid + int(n_pending_add)
        if ids.size and (ids[0] < 0 or ids[-1] >= bound):
            bad = ids[(ids < 0) | (ids >= bound)]
            raise KeyError(f"unknown doc ids {bad.tolist()[:8]} "
                           f"(allocator is at {bound})")
        return ids

    def delete(self, ids: Sequence[int]) -> int:
        """Tombstone global doc ids; returns how many were newly deleted.

        Unknown ids raise ``KeyError``; deleting a dead id is a no-op, so
        replaying a delete log is safe.
        """
        with self._lock:
            ids = self.validate_ids(ids)
            if ids.size == 0:
                return 0
            st = self._state
            newly = ids[~st.tomb[ids]]
            if newly.size == 0:
                return 0
            tomb = st.tomb.copy()
            tomb[newly] = True
            n_main_dead = int(tomb[self._main_gids].sum())
            new = _Snapshot(st.segments, tomb, st.next_gid,
                            st.n_live - int(newly.size), n_main_dead)
            # segments are unchanged: the concatenated delta view carries
            # over, so a delete costs O(tombstones), not O(delta bytes)
            new._delta = st._delta
            self._state = new
            return int(newly.size)

    # -- search ------------------------------------------------------------
    def _main_gids_device(self) -> torch.Tensor:
        if self._main_gids_t is None:
            self._main_gids_t = torch.from_numpy(self._main_gids) \
                .to(self.device).long()
        return self._main_gids_t

    def search(self, queries, k: int, nprobe: Optional[int] = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
        """Top-``min(k, live docs)`` across main + delta layers.

        Returns ``(scores, global int64 ids)`` in the strict
        ``(score desc, id asc)`` order; tombstoned rows never appear.
        ``nprobe`` overrides the probe width of an IVF main (the same width
        gates which delta rows are reachable).
        """
        if self._main_version is not None and \
                getattr(self.main, "_version", None) != self._main_version:
            raise ValueError(
                "main index changed under the SegmentedIndex (add/fit was "
                "called on it directly); mutate through the SegmentedIndex "
                "only")
        st = self._state
        queries = as_tensor(queries, self.device)
        k_eff = resolve_k(k, st.n_live)
        nprobe_r = None
        if self._is_ivf:
            nprobe_r = resolve_nprobe(nprobe, self.main.nlist,
                                      default=self.main.nprobe)
        elif nprobe is not None:
            raise ValueError("per-request nprobe needs an IVF main; "
                             f"{type(self.main).__name__} has none")

        # the main layer, probed deep enough that tombstones cannot crowd
        # the surviving top-k out of the candidates
        k_main = min(k_eff + st.n_main_dead, len(self.main))
        if self._is_ivf:
            vals_m, pos_m = self.main.search(queries, k_main, nprobe=nprobe_r)
        else:
            vals_m, pos_m = self.main.search(queries, k_main)
        gids_m = torch.where(pos_m >= 0,
                             self._main_gids_device()[pos_m.clamp(min=0)], -1)
        if not st.segments and st.n_main_dead == 0:
            return vals_m, gids_m          # nothing layered yet

        tomb = st.tomb_t(self.device)
        dead_m = (gids_m >= 0) & tomb[gids_m.clamp(min=0)]
        vals_m = vals_m.masked_fill(dead_m, NEG_INF)
        gids_m = gids_m.masked_fill(dead_m, -1)
        if st.segments:
            storage_d, _, gids_d, labels_d = st.delta(self.device)
            q_f = apply_float_stages(self.float_stages, queries, "queries")
            q_e = self.scorer.encode_queries(q_f)
            vals_d = self.scorer.scores(q_e, storage_d,
                                        params=self.scorer.params())
            if self._is_ivf:
                # the main layer's routing: a delta row competes only when
                # the list it was assigned to is probed
                _, probes = route(q_f.float(), self.main.centroids, self.sim,
                                  nprobe_r)
                probed = torch.zeros((queries.shape[0], self.main.nlist),
                                     dtype=torch.bool, device=self.device)
                probed.scatter_(1, probes.long(), True)
                vals_d = vals_d.masked_fill(~probed[:, labels_d], NEG_INF)
            vals_d = vals_d.masked_fill(tomb[gids_d][None, :], NEG_INF)
            vals = torch.cat([vals_m, vals_d], dim=1)
            ids = torch.cat([gids_m, gids_d[None, :].expand(
                queries.shape[0], -1)], dim=1)
        else:
            vals, ids = vals_m, gids_m
        return masked_topk_by_id(vals, ids, k_eff)

    def prefetch(self, queries, nprobe: Optional[int] = None) -> int:
        """Warm a store-backed IVF main's hot tier; returns the lists
        touched (0 when fully resident)."""
        if not self._is_ivf:
            return 0
        return self.main.prefetch(queries, nprobe=nprobe)

    # -- drift / compaction policy ----------------------------------------
    def needs_compaction(self) -> bool:
        """True when the delta or tombstone fraction outgrows
        ``max_delta_fraction``, or added docs drifted past
        ``drift_threshold`` from the pipeline's fitted centering stats."""
        st = self._state
        total = len(self.main) + st.n_delta
        if st.n_delta > self.max_delta_fraction * total:
            return True
        if (total - st.n_live) > self.max_delta_fraction * total:
            return True
        return self.drift.mean_shift > self.drift_threshold

    def mutable_stats(self) -> dict:
        """Snapshot for dashboards: sizes, drift and the fold trigger."""
        st = self._state
        return {
            "n_live": st.n_live,
            "n_main": len(self.main),
            "n_delta": st.n_delta,
            "segments": len(st.segments),
            "tombstones": len(self.main) + st.n_delta - st.n_live,
            "next_gid": st.next_gid,
            "drift": self.drift.stats(),
            "needs_compaction": self.needs_compaction(),
        }

    def place(self) -> "SegmentedIndex":
        """The serving layer's staging hook: a single-host main is placed
        on its device already, so there is nothing to force."""
        return self

    def shard_stats(self) -> None:
        """Per-shard rollup of a sharded main: None, as ``repro`` answers
        for a single-host main — sharded mains wait for the sharding
        slice, and the constructor refuses them."""
        return None

    # -- compaction --------------------------------------------------------
    def _main_storage(self) -> torch.Tensor:
        if isinstance(self.main, DenseIndex):
            return self.main.docs
        return self.main.storage

    def _iter_folded_lists(self, st: _Snapshot):
        """List-major fold stream for IVF compaction.

        Yields ``(lid, rows, new_ids, gids)`` per inverted list in list
        order: the list's alive main rows (storage-position order), then
        its alive delta rows (segment order), ``new_ids`` the sequential
        row positions of the folded index; rows on the host in the port's
        dtypes.  Works off a resident main or its store, one list at a
        time — the whole main is never decoded or concatenated.
        """
        main = self.main
        tomb = st.tomb
        if st.segments:
            d_rows = np.concatenate(
                [s.storage.cpu().numpy() for s in st.segments])
            d_gids = np.concatenate([s.gids for s in st.segments])
            d_labels = np.concatenate([s.labels for s in st.segments])
            alive_d = ~tomb[d_gids]
            order = np.argsort(d_labels[alive_d], kind="stable")
            d_rows = d_rows[alive_d][order]
            d_gids = d_gids[alive_d][order]
            d_labels = d_labels[alive_d][order]
        else:
            d_labels = np.zeros(0, np.int32)
            d_rows = d_gids = None
        pos = 0
        for lid, rows_m, ids_m in main.iter_lists():
            gids_m = self._main_gids[np.asarray(ids_m)]
            alive = ~tomb[gids_m]
            parts_r = [port_rows(np.asarray(rows_m))[alive]]   # a copy
            parts_g = [gids_m[alive]]
            lo = np.searchsorted(d_labels, lid, "left")
            hi = np.searchsorted(d_labels, lid, "right")
            if hi > lo:
                parts_r.append(d_rows[lo:hi])
                parts_g.append(d_gids[lo:hi])
            rows = (np.concatenate(parts_r) if len(parts_r) > 1
                    else parts_r[0])
            gids = (np.concatenate(parts_g) if len(parts_g) > 1
                    else parts_g[0])
            new_ids = np.arange(pos, pos + len(gids), dtype=np.int32)
            pos += len(gids)
            yield lid, rows, new_ids, gids

    def _make_ivf_like_main(self) -> IVFIndex:
        """Fresh unfitted shell with the main's ctor params and frozen
        scorer state."""
        main = self.main
        if isinstance(main, IVFFlatIndex):
            new_main = IVFFlatIndex(
                nlist=main._nlist_requested, nprobe=main.nprobe,
                sim=main.sim, kmeans_iters=main.kmeans_iters,
                kmeans_init=main.kmeans_init, balanced=main.balanced,
                device=main.device)
        else:
            new_main = IVFIndex(
                main.pipeline, nlist=main._nlist_requested,
                nprobe=main.nprobe, sim=main.sim, backend=main.backend,
                kmeans_iters=main.kmeans_iters,
                kmeans_init=main.kmeans_init, balanced=main.balanced,
                device=main.device)
        new_main.float_stages = self.float_stages
        new_main.scorer.load_extra_state(self.scorer.extra_state())
        return new_main

    def _wrap_compacted(self, new_main, st: _Snapshot,
                        gids: np.ndarray) -> "SegmentedIndex":
        new_main.spec = getattr(self.main, "spec", None)
        out = SegmentedIndex(new_main, spec=self.spec,
                             drift_threshold=self.drift_threshold,
                             max_delta_fraction=self.max_delta_fraction)
        # tombstoned ids stay marked forever: the gid space has holes after
        # compaction, and a replayed delete of a folded id stays a no-op
        out._restore(main_gids=gids, tomb=st.tomb.copy(),
                     next_gid=st.next_gid)
        return out

    def _compact_chunked(self, st: _Snapshot, out_path: str,
                         resident) -> "SegmentedIndex":
        """Fold straight into a chunked (v3) artifact at ``out_path`` —
        list by list, keeping the existing router, without decoding (or
        even concatenating) the main storage — then serve the fold back at
        the requested residency."""
        from repro_torch.retrieval.api import (_chunked_header, _rows_layout,
                                               _write_chunked, load_index)
        main = self.main
        meta, aux = _chunked_header(main, None, self.spec)
        meta["index"]["n_docs"] = st.n_live
        meta["index"]["version"] = main._version + 1
        dtype, width = _rows_layout(main)
        gid_parts = []

        def _rows():
            for _, rows, new_ids, gids in self._iter_folded_lists(st):
                gid_parts.append(gids)
                yield rows, new_ids

        _write_chunked(out_path, meta, aux, _rows(), storage_dtype=dtype,
                       storage_width=width, n_lists=main.nlist)
        new_main = load_index(out_path, resident=resident,
                              device=main.device)
        return self._wrap_compacted(new_main, st, np.concatenate(gid_parts))

    def compact(self, rng: Optional[torch.Generator] = None, *,
                out_path: Optional[str] = None,
                resident="auto") -> "SegmentedIndex":
        """Fold segments + tombstones into a fresh main; returns a NEW
        SegmentedIndex (self keeps serving unchanged).

        Storage rows are moved, never re-encoded: the fitted pipeline,
        codebooks and global doc ids carry over, so exact mains rank the
        surviving rows as before.  Resident IVF mains refit only the
        k-means router on the float decode of the moved storage.  Two
        tiered flavours keep the router instead (delta rows were routed to
        it, so the fold is exact) and never decode the main:

        * ``out_path=`` (IVF mains only) streams the fold list by list into
          a chunked v3 artifact at that path and serves it back at
          ``resident=`` residency;
        * a store-backed main without ``out_path`` folds in memory into a
          fully resident new main.
        """
        st = self._state
        main = self.main
        if st.n_live == 0:
            raise ValueError("cannot compact to an empty index — every doc "
                             "is tombstoned")
        if out_path is not None:
            if not self._is_ivf:
                raise TypeError("chunked compaction (out_path=) lays out "
                                "IVF inverted lists — "
                                f"{type(main).__name__} has none")
            return self._compact_chunked(st, out_path, resident)
        if self._is_ivf and main.store is not None:
            rows_all, labels_all, gid_parts = [], [], []
            for lid, rows, _, gids in self._iter_folded_lists(st):
                rows_all.append(rows)
                labels_all.append(np.full(len(gids), lid, np.int32))
                gid_parts.append(gids)
            new_main = self._make_ivf_like_main()
            new_main._install_routed(
                torch.from_numpy(np.concatenate(rows_all)),
                np.concatenate(labels_all), main.centroids, main._dim)
            return self._wrap_compacted(new_main, st,
                                        np.concatenate(gid_parts))
        alive_main = torch.from_numpy(~st.tomb[self._main_gids]) \
            .to(self.device)
        parts = [self._main_storage()[alive_main]]
        gid_parts = [self._main_gids[~st.tomb[self._main_gids]]]
        for seg in st.segments:
            alive = ~st.tomb[seg.gids]
            parts.append(seg.storage[torch.from_numpy(alive)
                                     .to(seg.storage.device)])
            gid_parts.append(seg.gids[alive])
        storage = torch.cat(parts)
        gids = np.concatenate(gid_parts)

        if isinstance(main, DenseIndex):
            new_main = DenseIndex(storage, sim=main.sim, device=main.device,
                                  backend=main.backend)
        elif self._is_ivf:
            new_main = self._make_ivf_like_main()
            x_route = new_main.scorer.decode(storage)
            new_main._install(storage, x_route, rng=rng)
        else:
            new_main = CompressedIndex(main.pipeline, sim=main.sim,
                                       backend=main.backend,
                                       device=main.device)
            new_main.float_stages = self.float_stages
            new_main.scorer.load_extra_state(self.scorer.extra_state())
            new_main.storage = storage
            new_main._n_docs = int(storage.shape[0])
            new_main._dim = main._dim
            new_main._version = 1
        return self._wrap_compacted(new_main, st, gids)

    # -- persistence -------------------------------------------------------
    def state_dict(self) -> dict:
        st = self._state
        return {
            "main": self.main.state_dict(),
            "main_kind": type(self.main).__name__,
            "main_gids": self._main_gids,
            "tombstones": np.flatnonzero(st.tomb).astype(np.int64),
            "next_gid": st.next_gid,
            "segments": [{"storage": s.storage, "gids": s.gids,
                          "labels": s.labels} for s in st.segments],
            "drift": self.drift.state_dict(),
        }

    def save(self, path: str) -> None:
        from repro_torch.retrieval.api import save_index
        save_index(self, path)

    @classmethod
    def load(cls, path: str, device=None) -> "SegmentedIndex":
        from repro_torch.retrieval.api import load_index
        return load_index(path, expect=cls, device=device)
