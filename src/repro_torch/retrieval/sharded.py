"""Sharded KB search over a mesh of devices, driven by one process.

Counterpart of ``repro.retrieval.sharded``.  ``repro`` runs one program
over its mesh through ``shard_map``; here one process drives every shard
the same way, over a :class:`~repro_torch.parallel.placement.Mesh` of
``torch.device``\\ s, so a serving thread calls ``index.search`` as it
would on one card.

Layout
------
* Document index: split over the ``doc_axis`` shards — exact search by
  rows (``ceil(n / shards)`` a shard, the last one ragged, no pad rows),
  IVF by whole inverted lists under a greedy size balance
  (:func:`partition_ivf_lists`, ``repro``'s own).
* Queries: split by rows over the ``query_axis`` (the replicas) when
  given, padded to divide it and trimmed (:func:`_pad_queries`); else
  every shard sees the whole batch.

Schedule (per query shard)::

    encode the batch once on the lead device    # float stages, routing
    copy the queries to each shard's device
    local scores + local top-k                  # the single-host kernels
    copy each shard's (Q, k) to the lead device # k·(score + id) a shard
    global top-k merge                          # masked_topk_by_id

The per-query traffic is ``O(n_doc_shards · k · 8 bytes)`` whatever the
KB's size: a peer copy across cards, nothing where shards share a card.
Each shard runs the single-host index's own code on its rows — the
scorer kernel (``int8_ip`` with the q·zero bias in its epilogue,
``binary_ip``) and the one exact loop (``topk_blocks`` → ``topk_merge``),
one ``fused_ivf_topk`` launch over the batch for IVF — and the merge ranks
by ``(score desc, id asc)``, so rankings equal the single-host index's in
ids and score bits.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core.pipeline import CompressionPipeline
from repro_torch.core.preprocess import as_tensor
from repro_torch.parallel.placement import (Mesh, device_grid,
                                            place_shards)
from repro_torch.retrieval.index import QUERY_CHUNK, storage_tensor
from repro_torch.retrieval.ivf import (PROBE_BLOCK, IVFIndex, _pad_probe,
                                       route)
from repro_torch.retrieval.scorers import (Scorer, apply_float_stages,
                                           encode_storage,
                                           scorer_for_pipeline)
from repro_torch.retrieval.topk import (NEG_INF, _exact_topk,
                                        masked_topk_by_id, merge_topk_block,
                                        resolve_k, resolve_nprobe,
                                        topk_search)
from repro_torch.utils import DeviceLike, check_backend, chunked

AxisName = Union[str, Sequence[str]]

def _as_tuple(axis: Optional[AxisName]) -> tuple[str, ...]:
    if axis is None:
        return ()
    return (axis,) if isinstance(axis, str) else tuple(axis)


def _pad_queries(q: torch.Tensor, n_query_shards: int
                 ) -> tuple[torch.Tensor, int]:
    """Pad rows with zeros to divide the query (replica) axis; returns the
    padded block and the true row count so callers trim the outputs.
    Padded rows score but never surface — the trim drops them whole."""
    n = int(q.shape[0])
    pad = (-n) % max(1, n_query_shards)
    if pad:
        q = torch.cat([q, q.new_zeros((pad,) + tuple(q.shape[1:]))])
    return q, n


def shard_bounds(n: int, n_shards: int) -> list[tuple[int, int]]:
    """``repro``'s row split: ``ceil(n / shards)`` rows a shard, the last
    ragged (or empty where ``n`` is small); (start, stop) per shard."""
    rows_per = -(-n // n_shards) if n else 0
    return [(min(n, s * rows_per), min(n, (s + 1) * rows_per))
            for s in range(n_shards)]


def _fan_out(grid: np.ndarray, n_rows: int, k: int,
             local: Callable[[int, int, slice],
                             Optional[tuple[torch.Tensor, torch.Tensor]]]
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Run ``local(r, s, rows)`` for every (query shard, doc shard) of the
    grid — its (rows, ·) candidates with *global* ids on the shard's
    device, or None for a shard with nothing to score — and merge each
    query shard's candidates on the lead device in shard order.
    ``n_rows`` divides the query shards."""
    n_q, n_d = grid.shape
    lead = grid[0, 0]
    per = n_rows // n_q
    out_v, out_i = [], []
    for r in range(n_q):
        rows = slice(r * per, (r + 1) * per)
        cand_v, cand_i = [], []
        for s in range(n_d):
            got = local(r, s, rows)
            if got is not None:
                cand_v.append(got[0].to(lead))
                cand_i.append(got[1].to(lead).long())
        if cand_v:
            v, i = masked_topk_by_id(torch.cat(cand_v, dim=1),
                                     torch.cat(cand_i, dim=1), k)
        else:
            v = torch.full((per, k), NEG_INF, device=lead)
            i = torch.full((per, k), -1, dtype=torch.long, device=lead)
        out_v.append(v)
        out_i.append(i)
    return torch.cat(out_v), torch.cat(out_i)


def _params_on(params: dict, device: torch.device) -> dict:
    return {n: t.to(device) for n, t in params.items()}


def make_sharded_scorer_search(mesh: Mesh, scorer: Scorer, *, k: int = 10,
                               doc_axis: AxisName = "model",
                               query_axis: Optional[AxisName] = None):
    """Sharded quantized search: ``(q, shards, offsets, params) → (vals,
    ids)``.

    ``q`` holds the scorer-encoded queries on the lead device;
    ``shards[r][s]`` doc shard ``s``'s encoded rows on the device of query
    shard ``r`` (:func:`place_shards`), ``offsets[s]`` its first global
    row; ``params`` is ``scorer.params()``.  Each shard scores with the
    scorer's kernel in the exact loop, ``QUERY_CHUNK`` queries at a time,
    as :meth:`CompressedIndex.search` does.
    """
    doc_axes, q_axes = _as_tuple(doc_axis), _as_tuple(query_axis)
    if not doc_axes:
        raise ValueError("doc_axis must name at least one mesh axis")
    grid = device_grid(mesh, doc_axes, q_axes)

    def search(q, shards, offsets, params):
        q, n = _pad_queries(q, grid.shape[0])

        def local(r, s, rows):
            stor = shards[r][s]
            if stor.shape[0] == 0:
                return None
            p = _params_on(params, stor.device)
            v, i = _exact_topk(
                lambda qc, d: scorer.scores(qc, d, params=p),
                (q[rows].to(stor.device),), stor, min(k, int(stor.shape[0])),
                kernel=scorer.use_kernel(stor), query_chunk=QUERY_CHUNK,
                doc_chunk=int(stor.shape[0]))
            return v, i + offsets[s]

        vals, ids = _fan_out(grid, q.shape[0], k, local)
        return vals[:n], ids[:n]

    return search


def make_distributed_search(mesh: Mesh, *, sim: str = "ip", k: int = 10,
                            query_axis: Optional[AxisName] = "data",
                            doc_axis: AxisName = "model",
                            backend: str = "auto", doc_chunk: int = 131072):
    """Float sharded search: ``(queries, shards, offsets) → (scores,
    global ids)``, ``shards[r][s]`` float rows (see :func:`shard_index`).

    The dense path; the quantized backends go through
    :func:`make_sharded_scorer_search` (the same schedule).  Each shard
    runs :func:`~repro_torch.retrieval.topk.topk_search`.
    """
    doc_axes, q_axes = _as_tuple(doc_axis), _as_tuple(query_axis)
    grid = device_grid(mesh, doc_axes, q_axes)

    def search(queries, shards, offsets):
        q, n = _pad_queries(queries, grid.shape[0])

        def local(r, s, rows):
            docs = shards[r][s]
            if docs.shape[0] == 0:
                return None
            v, i = topk_search(q[rows].to(docs.device), docs,
                               min(k, int(docs.shape[0])), sim=sim,
                               doc_chunk=doc_chunk, backend=backend)
            return v, i + offsets[s]

        vals, ids = _fan_out(grid, q.shape[0], k, local)
        return vals[:n], ids[:n]

    return search


def shard_index(docs: torch.Tensor, mesh: Mesh, doc_axis: AxisName = "model",
                query_axis: Optional[AxisName] = None
                ) -> tuple[list, list[int]]:
    """Split rows over the doc shards and place them: (``placed[r][s]``,
    the shards' first global rows)."""
    grid = device_grid(mesh, _as_tuple(doc_axis), _as_tuple(query_axis))
    bounds = shard_bounds(int(docs.shape[0]), grid.shape[1])
    placed = place_shards([[docs[a:b]] for a, b in bounds], grid)
    return [[t[0] for t in row] for row in placed], [a for a, _ in bounds]


class _MeshAxes:
    """The mesh, its axes and the (query shards, doc shards) device grid."""

    def _set_mesh(self, mesh: Mesh, doc_axis: AxisName,
                  query_axis: Optional[AxisName]) -> None:
        self.mesh = mesh
        self.doc_axes = _as_tuple(doc_axis)
        if not self.doc_axes:
            raise ValueError("doc_axis must name at least one mesh axis")
        self.query_axis = query_axis
        self._grid = device_grid(mesh, self.doc_axes, _as_tuple(query_axis))

    @property
    def n_doc_shards(self) -> int:
        return int(self._grid.shape[1])

    @property
    def n_query_shards(self) -> int:
        return int(self._grid.shape[0])


class ShardedCompressedIndex(_MeshAxes):
    """Compressed index row-split over a mesh, single-host API.

    Mirrors :class:`~repro_torch.retrieval.index.CompressedIndex`
    (``build`` / ``add`` / ``search`` / ``nbytes``): the encoded storage
    is kept whole on the lead device (the mesh's first) and split by rows
    over the doc shards at placement; each shard is scored by the same
    scorer path as the single-host index and the per-shard top-k are
    merged.  Rankings equal the single-host index's in ids and score bits.
    """

    #: sharded storage is always fully resident (Index-protocol surface:
    #: the serving tier rollup reads ``store`` uniformly)
    store = None

    def __init__(self, pipeline: CompressionPipeline, mesh: Mesh,
                 sim: str = "ip", backend: str = "auto",
                 doc_axis: AxisName = "model",
                 query_axis: Optional[AxisName] = None):
        self._set_mesh(mesh, doc_axis, query_axis)
        self.device = self._grid[0, 0]
        self.pipeline = pipeline
        self.sim = sim
        self.backend = check_backend(backend)
        self.float_stages, self.scorer = scorer_for_pipeline(
            pipeline, sim=sim, backend=self.backend)
        self._storage_host: Optional[torch.Tensor] = None  # whole, on lead
        self._placed = None            # placed[r][s]: shard s's rows
        self._offsets: list[int] = []
        self.spec = None               # set by api.build_index / api.load_index
        self._n_docs = 0
        self._dim = 0

    # -- construction -----------------------------------------------------
    @classmethod
    def build(cls, docs, queries_sample, pipeline: CompressionPipeline,
              mesh: Mesh, sim: str = "ip", backend: str = "auto",
              doc_axis: AxisName = "model",
              query_axis: Optional[AxisName] = None,
              rng: Optional[torch.Generator] = None
              ) -> "ShardedCompressedIndex":
        """Fit ``pipeline`` on the lead device, then encode and shard."""
        idx = cls(pipeline, mesh, sim=sim, backend=backend,
                  doc_axis=doc_axis, query_axis=query_axis)
        docs = as_tensor(docs, idx.device)
        if queries_sample is not None:
            queries_sample = as_tensor(queries_sample, idx.device)
        pipeline.fit(docs, queries_sample, rng=rng)
        return idx.add(docs)

    @classmethod
    def from_index(cls, idx, mesh: Mesh, *, doc_axis: AxisName = "model",
                   query_axis: Optional[AxisName] = None
                   ) -> "ShardedCompressedIndex":
        """Wrap a built single-host
        :class:`~repro_torch.retrieval.index.CompressedIndex` over
        ``mesh``: its pipeline, scorer state and encoded rows as they are
        (the rows on the lead device, split over the shards at
        placement), so rankings equal ``idx``'s."""
        out = cls(idx.pipeline, mesh, sim=idx.sim, backend=idx.backend,
                  doc_axis=doc_axis, query_axis=query_axis)
        out.scorer.load_extra_state(idx.scorer.extra_state())
        out._storage_host = idx.storage.to(out.device)
        out._n_docs = len(idx)
        out._dim = idx._dim
        return out

    @property
    def storage(self) -> Optional[torch.Tensor]:
        """Unsharded encoded rows (single-host view for persistence and
        the mutable wrapper's compaction path)."""
        return self._storage_host

    def shard_stats(self) -> list[dict]:
        """Per-shard rollup for ``RetrievalService.stats()``: rows split
        over the doc shards, ``ceil(n / shards)`` a shard."""
        return [{"shard": i, "n_docs": b - a} for i, (a, b) in
                enumerate(shard_bounds(self._n_docs, self.n_doc_shards))]

    def add(self, docs) -> "ShardedCompressedIndex":
        """Encode ``docs`` as the single-host index does
        (:func:`~repro_torch.retrieval.scorers.encode_storage`: the
        one-pass ``fused_quantize`` for the pre+post-normalized 24× recipe
        with kernel numerics) and append; placement is redone lazily."""
        enc, self._dim = encode_storage(self.float_stages, self.scorer,
                                        as_tensor(docs, self.device))
        self._storage_host = (enc if self._storage_host is None
                              else torch.cat([self._storage_host, enc]))
        self._n_docs = int(self._storage_host.shape[0])
        self._placed = None            # re-place lazily on next search
        return self

    def __len__(self) -> int:
        return self._n_docs

    @property
    def nbytes(self) -> int:
        if self._storage_host is None:
            raise ValueError("index is empty")
        return self._storage_host.numel() * self._storage_host.element_size()

    def place(self) -> "ShardedCompressedIndex":
        """Force placement *now* (it is otherwise lazy until the first
        search): every shard lands on its device or this raises.  The
        serving layer calls this at engine construction so staging a
        sharded version is all-or-none rather than failing mid-query."""
        self._placed_storage()
        return self

    # -- search ------------------------------------------------------------
    def _float_path(self) -> bool:
        return self.scorer.name in ("float", "fp16")

    def _placed_storage(self):
        if self._placed is None:
            if self._storage_host is None:
                raise ValueError("index is empty")
            placed, self._offsets = shard_index(
                self._storage_host, self.mesh, self.doc_axes, self.query_axis)
            if self._float_path():
                # float and fp16 shards search their float view, decoded
                # once a placed copy (replicas on one device share it)
                views: dict[int, torch.Tensor] = {}
                for row in placed:
                    for t in row:
                        if id(t) not in views:
                            views[id(t)] = self.scorer.decode(t)
                placed = [[views[id(t)] for t in row] for row in placed]
            self._placed = placed
        return self._placed

    def encode_queries(self, queries) -> torch.Tensor:
        """Queries through the float stages, on the lead device."""
        return apply_float_stages(self.float_stages,
                                  as_tensor(queries, self.device), "queries")

    def search(self, queries, k: int, doc_chunk: int = 131072
               ) -> tuple[torch.Tensor, torch.Tensor]:
        k = resolve_k(k, self._n_docs)
        placed = self._placed_storage()
        queries = as_tensor(queries, self.device)
        if self._float_path():
            fn = make_distributed_search(
                self.mesh, sim=self.sim, k=k, query_axis=self.query_axis,
                doc_axis=self.doc_axes, backend=self.backend,
                doc_chunk=doc_chunk)
            return fn(self.encode_queries(queries), placed, self._offsets)
        fn = make_sharded_scorer_search(self.mesh, self.scorer, k=k,
                                        doc_axis=self.doc_axes,
                                        query_axis=self.query_axis)
        # encoded in the single-host index's query chunks, so every
        # query-side product sees the rows it sees there
        q = torch.cat([self.scorer.encode_queries(
            self.encode_queries(queries[a:b]))
            for a, b in chunked(max(1, queries.shape[0]), QUERY_CHUNK)])
        return fn(q, placed, self._offsets, self.scorer.params())

    # -- persistence -------------------------------------------------------
    def state_dict(self) -> dict:
        """Single-host state: the *unsharded* encoded storage plus pipeline
        state.  Placement is redone at load time from the ShardSpec."""
        return {"pipeline": self.pipeline.state_dict(),
                "storage": self._storage_host,
                "scorer_extra": self.scorer.extra_state(),
                "n_docs": self._n_docs, "dim": self._dim}

    def load_state_dict(self, sd: dict) -> "ShardedCompressedIndex":
        """Load state from tensors or numpy arrays (``repro``'s artifacts)."""
        self.pipeline.load_state_dict(sd["pipeline"], self.device)
        self._storage_host = storage_tensor(sd["storage"], self.device)
        self.scorer.load_extra_state(sd.get("scorer_extra", {}))
        self._n_docs = int(sd["n_docs"])
        self._dim = int(sd["dim"])
        self._placed = None
        return self

    def save(self, path: str) -> None:
        from repro_torch.retrieval.api import save_index
        save_index(self, path)

    @classmethod
    def load(cls, path: str, mesh: Optional[Mesh] = None, *, shard=None,
             device: DeviceLike = None) -> "ShardedCompressedIndex":
        """Load from an artifact; the mesh derives from the embedded (or
        passed) ShardSpec on ``device`` — ``mesh=`` is deprecated but
        still honoured."""
        from repro_torch.retrieval.api import load_index
        return load_index(path, mesh=mesh, expect=cls, shard=shard,
                          device=device)


# ---------------------------------------------------------------------------
# sharded IVF: inverted lists partitioned over the doc shards
# ---------------------------------------------------------------------------


def partition_ivf_lists(lists: np.ndarray, storage: np.ndarray,
                        n_shards: int
                        ) -> tuple[np.ndarray, np.ndarray, np.ndarray,
                                   np.ndarray]:
    """Partition inverted lists over shards, greedily balancing doc counts
    (``repro``'s partition, so list owners are the same).

    ``lists`` is the (nlist, max_len) global-doc-id matrix (−1 padded);
    ``storage`` the (n_docs, …) encoded rows.  Returns stacked per-shard
    arrays, plus the ownership map:

    * ``lists_stacked``   (n_shards·nlist, max_len) — local row ids, −1 for
      pad *and* for lists the shard does not own;
    * ``storage_stacked`` (n_shards·rows_max, …)    — shard-local rows;
    * ``gids_stacked``    (n_shards·rows_max,)      — global doc ids, −1 pad;
    * ``owner``           (nlist,)                  — which shard owns each
      list (feeds the per-shard stats rollup).
    """
    nlist, max_len = lists.shape
    sizes = (lists >= 0).sum(axis=1)
    owner = np.zeros(nlist, np.int32)
    loads = np.zeros(n_shards, np.int64)
    for c in np.argsort(-sizes, kind="stable"):   # biggest list first
        s = int(np.argmin(loads))
        owner[c] = s
        loads[s] += sizes[c]
    rows_max = max(1, int(loads.max()))

    lists_stacked = np.full((n_shards * nlist, max_len), -1, np.int32)
    storage_stacked = np.zeros((n_shards * rows_max,) + storage.shape[1:],
                               storage.dtype)
    gids_stacked = np.full((n_shards * rows_max,), -1, np.int32)
    for s in range(n_shards):
        r = 0
        for c in np.flatnonzero(owner == s):
            ids = lists[c][lists[c] >= 0]
            storage_stacked[s * rows_max + r: s * rows_max + r + len(ids)] = \
                storage[ids]
            gids_stacked[s * rows_max + r: s * rows_max + r + len(ids)] = ids
            lists_stacked[s * nlist + c, : len(ids)] = \
                np.arange(r, r + len(ids), dtype=np.int32)
            r += len(ids)
    return lists_stacked, storage_stacked, gids_stacked, owner


class ShardedIVFIndex(_MeshAxes):
    """IVF index with inverted lists partitioned over the mesh's doc shards.

    Each shard owns a balanced subset of the lists and the encoded rows of
    exactly those lists.  The batch is routed once on the wrapped index's
    device with its own ``route``; each shard scores only the probed lists
    it owns — where the single-host index takes the fused kernel, as a
    list-major layout of its owned lists plus one empty list, searched by
    one ``fused_ivf_topk`` launch, an unowned probe at −1 (skipped);
    elsewhere by the single-host streaming path over its rows — and
    the shards' top-k merge by ``(score desc, id asc)``.  Wraps a fitted
    :class:`~repro_torch.retrieval.ivf.IVFIndex` (centroids and lists as
    they are), so rankings equal the single-host index's.
    """

    #: sharded lists are always fully resident (Index-protocol surface:
    #: the serving tier rollup reads ``store`` uniformly)
    store = None

    def __init__(self, ivf: IVFIndex, mesh: Mesh,
                 doc_axis: AxisName = "model",
                 query_axis: Optional[AxisName] = None):
        if ivf.storage is None:
            raise ValueError("IVFIndex must be fitted (and fully resident) "
                             "before sharding")
        if getattr(ivf, "residual", False):
            raise ValueError(
                "ShardedIVFIndex cannot wrap a residual-encoded IVFIndex: "
                "the shard-local probe_and_score path has no routed "
                "q·centroid correction — build with residual=False")
        self._set_mesh(mesh, doc_axis, query_axis)
        self.ivf = ivf
        self.scorer = ivf.scorer
        self.float_stages = ivf.float_stages
        self.sim = ivf.sim
        self._snapshot_version = ivf._version   # partition frozen at this fit
        self._fused = ivf._use_fused_kernel
        lists_np = ivf.lists.cpu().numpy()
        lists_s, storage_s, gids_s, owner = partition_ivf_lists(
            lists_np, ivf.storage.cpu().numpy(), self.n_doc_shards)
        self.list_owner = owner        # (nlist,) → shard, for stats rollup
        nlist = lists_np.shape[0]
        rows_max = storage_s.shape[0] // self.n_doc_shards
        shards = []
        for s in range(self.n_doc_shards):
            loc = lists_s[s * nlist: (s + 1) * nlist]
            rows = storage_s[s * rows_max: (s + 1) * rows_max]
            gids = gids_s[s * rows_max: (s + 1) * rows_max]
            shards.append(self._shard_layout(loc, rows, gids, owner == s))
        self._shards = place_shards(shards, self._grid)
        self.spec = None               # set by api.build_index / api.load_index

    def _shard_layout(self, loc: np.ndarray, rows: np.ndarray,
                      gids: np.ndarray, owned: np.ndarray
                      ) -> list[torch.Tensor]:
        """One shard's tensors, on the host.  Fused: the (n_owned + 1, L,
        w) list-major storage of its owned lists (L their longest) with
        the empty list last, their global ids (−1 pad), and the (nlist,)
        global → local list map (unowned → −1: skipped by the kernel, the
        empty last list in its plain version).  Streaming:
        its (nlist, max_len) local row table, rows and global ids."""
        if not self._fused:
            return [torch.from_numpy(loc), torch.from_numpy(rows),
                    torch.from_numpy(gids)]
        own = np.flatnonzero(owned)
        table = loc[own]
        length = max(1, int((table >= 0).sum(axis=1).max(initial=0)))
        table = np.concatenate([table[:, :length],
                                np.full((1, length), -1, np.int32)])
        valid = table >= 0
        list_storage = rows[np.where(valid, table, 0)]
        list_storage[~valid] = 0
        list_ids = np.where(valid, gids[np.where(valid, table, 0)], -1)
        g2l = np.full(loc.shape[0], -1, np.int32)
        g2l[own] = np.arange(len(own), dtype=np.int32)
        return [torch.from_numpy(list_storage),
                torch.from_numpy(list_ids.astype(np.int32)),
                torch.from_numpy(g2l)]

    @property
    def device(self) -> torch.device:
        """The lead device: routing, the merge, a delta layer's home."""
        return self.ivf.device

    def place(self) -> "ShardedIVFIndex":
        """Already placed — the constructor put every shard's lists,
        storage and id map on its device (or raised).  Kept so the
        serving layer can call ``place()`` uniformly on any sharded
        index at engine construction."""
        return self

    # -- construction -----------------------------------------------------
    @classmethod
    def build(cls, docs, queries_sample=None,
              pipeline: Optional[CompressionPipeline] = None, *,
              mesh: Mesh, nlist: int = 200, nprobe: int = 100,
              sim: str = "ip", backend: str = "auto",
              kmeans_iters: int = 15, doc_axis: AxisName = "model",
              query_axis: Optional[AxisName] = None,
              rng: Optional[torch.Generator] = None) -> "ShardedIVFIndex":
        grid = device_grid(mesh, _as_tuple(doc_axis), _as_tuple(query_axis))
        ivf = IVFIndex.build(docs, queries_sample, pipeline, nlist=nlist,
                             nprobe=nprobe, sim=sim, backend=backend,
                             kmeans_iters=kmeans_iters, rng=rng,
                             device=grid[0, 0])
        return cls(ivf, mesh, doc_axis=doc_axis, query_axis=query_axis)

    def __len__(self) -> int:
        return len(self.ivf)

    def add(self, docs) -> "ShardedIVFIndex":
        """The list partition is frozen at construction — grow the wrapped
        :class:`IVFIndex` and rebuild the wrapper instead."""
        raise NotImplementedError(
            "ShardedIVFIndex cannot add in place; call ivf.add(docs) and "
            "re-wrap with ShardedIVFIndex(ivf, mesh)")

    @property
    def nbytes(self) -> int:
        return self.ivf.nbytes

    @property
    def nlist(self) -> int:
        return self.ivf.nlist

    @property
    def nprobe(self) -> int:
        return self.ivf.nprobe

    # -- Index-protocol surface delegated to the wrapped single-host IVF
    # (lets SegmentedIndex layer deltas over a sharded main and the serving
    # stats read one schema) ------------------------------------------------
    @property
    def centroids(self):
        return self.ivf.centroids

    @property
    def pipeline(self):
        return self.ivf.pipeline

    @property
    def storage(self):
        """Unsharded encoded rows (single-host view for persistence and
        the mutable wrapper's compaction path)."""
        return self.ivf.storage

    @property
    def lists(self):
        return self.ivf.lists

    @property
    def backend(self):
        return self.ivf.backend

    @property
    def residual(self) -> bool:
        return False                   # rejected at construction

    @property
    def _version(self):
        return self.ivf._version

    @property
    def _nlist_requested(self):
        return self.ivf._nlist_requested

    @property
    def _dim(self):
        return self.ivf._dim

    @property
    def kmeans_iters(self):
        return self.ivf.kmeans_iters

    @property
    def kmeans_init(self):
        return self.ivf.kmeans_init

    @property
    def balanced(self):
        return self.ivf.balanced

    def prefetch(self, queries, nprobe: Optional[int] = None) -> int:
        return 0                       # always fully resident

    def shard_stats(self) -> list[dict]:
        """Per-shard rollup for ``RetrievalService.stats()``: docs and
        inverted lists owned by each shard under the greedy partition."""
        owner = self.list_owner
        sizes = (self.ivf.lists >= 0).sum(dim=1).cpu().numpy()
        return [{"shard": s,
                 "n_docs": int(sizes[owner == s].sum()),
                 "n_lists": int((owner == s).sum())}
                for s in range(self.n_doc_shards)]

    # -- search ------------------------------------------------------------
    def encode_queries(self, queries) -> torch.Tensor:
        return self.ivf.encode_queries(queries)

    def search(self, queries, k: int, nprobe: Optional[int] = None,
               query_chunk: int = 64) -> tuple[torch.Tensor, torch.Tensor]:
        """Top-``min(k, n_docs)`` over the probed lists, int64 ids, as
        :meth:`IVFIndex.search` ranks them: ``query_chunk`` bounds the
        streaming path's gathered block, the fused path takes the batch
        whole (one launch a shard and query shard)."""
        if self.ivf._version != self._snapshot_version:
            raise ValueError(
                "wrapped IVFIndex changed since sharding (fit/add was "
                "called); the list partition is frozen at construction — "
                "rebuild the ShardedIVFIndex")
        nprobe = resolve_nprobe(nprobe, self.ivf.nlist,
                                default=self.ivf.nprobe)
        k = resolve_k(k, len(self.ivf))
        queries = as_tensor(queries, self.device)
        params = self.scorer.params()
        if self._fused:
            vals, ids = self._fused_search(queries, k, nprobe, params)
        else:
            vals, ids = self._streaming_search(queries, k, nprobe,
                                               query_chunk, params)
        return vals, ids.long()

    def fused_inputs(self, queries, nprobe: int, params: dict):
        """The fused path's per-query inputs, made once on the lead device
        as the single-host fused search makes them (float stages, routing,
        ``prepare_queries``), then padded to divide the query shards:
        ``(qe, base_q, probe, n)``, ``n`` the true row count."""
        from repro_torch.kernels.ivf_fused.ops import prepare_queries
        q = self.encode_queries(queries).float()
        _, probe = route(q, self.ivf.centroids, self.sim, nprobe)
        name = self.scorer.name
        w = self._shards[0][0][0].shape[-1]
        qe, base_q = prepare_queries(
            q, name, params, packed_width=w if name == "onebit" else None)
        (qe, n), (base_q, _), (probe, _) = (
            _pad_queries(t, self.n_query_shards) for t in (qe, base_q, probe))
        return qe, base_q, probe, n

    def _fused_search(self, queries, k: int, nprobe: int, params: dict):
        """Route and encode the batch once, as the single-host fused search
        does, then one ``fused_ivf_topk`` launch a shard."""
        from repro_torch.kernels.ivf_fused import kernel as fused_kernel
        name = self.scorer.name
        qe, base_q, probe, n = self.fused_inputs(queries, nprobe, params)

        def local(r, s, rows):
            list_storage, list_ids, g2l = self._shards[r][s]
            dev = list_storage.device
            # an unowned probe maps to −1, which the kernel skips (its
            # plain version reads it as the empty last list): no sort,
            # gather or host sync a shard to cut the table
            probes = g2l[probe[rows].to(dev).long()]
            base = base_q[rows].to(dev)[:, None].expand(probes.shape)
            return fused_kernel.fused_ivf_topk(
                probes, qe[rows].to(dev), list_storage, list_ids,
                base.float().contiguous(), k, name)

        vals, ids = _fan_out(self._grid, qe.shape[0], k, local)
        return vals[:n], ids[:n]

    def _streaming_search(self, queries, k: int, nprobe: int,
                          query_chunk: int, params: dict):
        """Encode and route in the single-host index's query chunks, then
        each shard gathers → scores → merges ``PROBE_BLOCK`` lists a step
        over its own rows, candidates ranked by their global ids."""
        qes, probes = [], []
        for a, b in chunked(queries.shape[0], query_chunk):
            q = self.encode_queries(queries[a:b])
            probes.append(route(q, self.ivf.centroids, self.sim, nprobe)[1])
            qes.append(self.scorer.encode_queries(q))
        if not qes:
            return (torch.empty((0, k), device=self.device),
                    torch.empty((0, k), dtype=torch.long,
                                device=self.device))
        (qe, n), (probe, _) = (_pad_queries(torch.cat(t), self.n_query_shards)
                               for t in (qes, probes))
        g = min(PROBE_BLOCK, nprobe)

        def local(r, s, rows):
            loc, stor, gids = self._shards[r][s]
            dev = stor.device
            p = _params_on(params, dev)
            out_v, out_i = [], []
            for a, b in chunked(rows.stop - rows.start, query_chunk):
                q_c = qe[rows][a:b].to(dev)
                pr, lists_ext, _ = _pad_probe(probe[rows][a:b].to(dev), loc,
                                              [], g)
                n_q = q_c.shape[0]
                vals = torch.full((n_q, k), NEG_INF, device=dev)
                ids = torch.full((n_q, k), -1, dtype=torch.int32, device=dev)
                for j0 in range(0, pr.shape[1], g):
                    cand = lists_ext[pr[:, j0: j0 + g].long()].reshape(n_q, -1)
                    gathered = stor[cand.clamp(min=0).long()]
                    s_j = self.scorer.scores_gathered(q_c, gathered, params=p)
                    valid = cand >= 0
                    gid_j = torch.where(valid, gids[cand.clamp(min=0).long()],
                                        -1)
                    vals, ids = merge_topk_block(
                        vals, ids, torch.where(valid, s_j, NEG_INF), gid_j, k)
                out_v.append(vals)
                out_i.append(ids)
            return torch.cat(out_v), torch.cat(out_i)

        vals, ids = _fan_out(self._grid, qe.shape[0], k, local)
        return vals[:n], ids[:n]

    # -- persistence -------------------------------------------------------
    def state_dict(self) -> dict:
        """The wrapped single-host IVF state; the shard partition is a pure
        function of (lists, storage, n_shards) and is recomputed at load."""
        return {"ivf": self.ivf.state_dict()}

    def load_state_dict(self, sd: dict) -> "ShardedIVFIndex":
        # the partition is frozen at construction; loading state into an
        # existing wrapper would desynchronise it — reconstruct instead
        raise NotImplementedError(
            "ShardedIVFIndex partitions at construction; use "
            "ShardedIVFIndex.load(path) / api.load_index")

    def save(self, path: str) -> None:
        from repro_torch.retrieval.api import save_index
        save_index(self, path)

    @classmethod
    def load(cls, path: str, mesh: Optional[Mesh] = None, *, shard=None,
             device: DeviceLike = None) -> "ShardedIVFIndex":
        """Load from an artifact; the mesh derives from the embedded (or
        passed) ShardSpec on ``device`` — ``mesh=`` is deprecated but
        still honoured."""
        from repro_torch.retrieval.api import load_index
        return load_index(path, mesh=mesh, expect=cls, shard=shard,
                          device=device)
