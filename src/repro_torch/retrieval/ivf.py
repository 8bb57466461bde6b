"""IVF approximate nearest-neighbour search over quantized storage.

Counterpart of ``repro.retrieval.ivf``: a k-means coarse quantizer splits
the index into ``nlist`` inverted lists held in scorer-backend storage
(float / fp16 / uint8 codes / packed 1-bit words); a search scores only the
``nprobe`` lists whose centroids score highest for each query, so IVF
compounds with the paper's compression.

Two search paths give the same ranking in the strict (score desc, id asc)
order:

* the fused path — route, then one ``ivf_fused`` call for the whole batch
  gathers, scores and ranks the probed lists from a list-major copy of the
  storage (:meth:`IVFIndex._list_major_layout`); it scores each probed
  list once for all the batch's queries that probe it, so it takes the
  batch whole.  It serves the inner product for every backend (1-bit with
  the paper's offset 0.5) wherever the scorer uses kernel numerics;
* the streaming path — ``PROBE_BLOCK`` probed lists at a time are gathered
  and scored through ``Scorer.scores_gathered`` and folded into a running
  top-k (``merge_topk_block``).  Everything else runs here, and it is the
  numerics oracle.

A store-backed (tiered) index — ``load_index(path, resident=budget)`` on a
chunked v3 artifact — has no resident storage: its lists come from a
:class:`~repro_torch.storage.store.ListStore`, ``PROBE_BLOCK`` probe slots
at a time, one ``store.get`` per distinct list of a block, in ``repro``'s
order (so ``store.stats()`` after a search equals ``repro``'s).  Where the
resident index would take the fused path, each block's distinct lists are
stacked into a block-local list-major buffer (one host-to-device copy a
block) and ranked by one ``ivf_fused`` launch, whose top-k is folded into
the running top-k by ``masked_topk_by_id`` over both (exact under the
total order, in a fixed number of launches whatever k): a row's score does
not depend on where its list sits, so the tiered index gives the resident
index's bits.  Every other case streams
the block through ``scores_gathered``, as the resident streaming path.

Routing ranks the (Q, nlist) centroid scores with ``topk_score_then_id``,
which gives ``lax.top_k``'s lowest-index-first order.  ``fit`` clamps the
effective ``nlist`` to the corpus size (a cluster that k-means leaves
empty is an all-pad list); ``search`` returns ``min(k, n_docs)`` columns,
with (−inf, −1) in slots no probed list can fill.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.pipeline import CompressionPipeline
from repro_torch.core.preprocess import as_tensor
from repro_torch.retrieval.index import storage_tensor
from repro_torch.retrieval.kmeans import assign, assign_balanced, kmeans_fit
from repro_torch.retrieval.scorers import (Scorer, apply_float_stages,
                                           scorer_for_pipeline)
from repro_torch.retrieval.topk import (NEG_INF, masked_topk_by_id,
                                        merge_topk_block, resolve_k,
                                        resolve_nprobe, similarity,
                                        topk_score_then_id)
from repro_torch.utils import (DeviceLike, check_backend, cdiv,
                               resolve_device, use_kernel)

__all__ = ["IVFIndex", "IVFFlatIndex", "artifact_rows", "build_padded_lists",
           "port_rows", "probe_and_score", "route"]

#: probed lists gathered and scored per streaming step; the merge is
#: associative under the strict order, so any grouping ranks the same
PROBE_BLOCK = 2


def port_rows(rows: np.ndarray) -> np.ndarray:
    """A stored list's rows as the port holds them: 1-bit words, uint32 in
    an artifact, become int32 views of the same bytes (no copy)."""
    return rows.view(np.int32) if rows.dtype == np.uint32 else rows


def artifact_rows(rows: np.ndarray) -> np.ndarray:
    """Inverse of :func:`port_rows`: the dtype ``repro`` writes."""
    return rows.view(np.uint32) if rows.dtype == np.int32 else rows


def route(q: torch.Tensor, centroids: torch.Tensor, sim: str, nprobe: int
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """(Q, nprobe) centroid scores and probed list ids, highest first and
    equal scores to the lowest list id (``lax.top_k``'s order)."""
    cscores = similarity(q, centroids, sim)
    lids = torch.arange(centroids.shape[0], dtype=torch.int32,
                        device=q.device)
    return topk_score_then_id(cscores, lids, nprobe)


def _pad_probe(probe: torch.Tensor, lists: torch.Tensor,
               extras: list[torch.Tensor], g: int):
    """Pad the probe table to a multiple of ``g`` slots with a phantom
    all-pad list (id ``nlist``), so grouped streaming never counts a real
    list twice.  ``extras`` are per-(query, probe) columns padded with 0;
    every phantom candidate is masked by its id −1."""
    nlist = lists.shape[0]
    lists_ext = torch.cat([lists, torch.full((1, lists.shape[1]), -1,
                                             dtype=lists.dtype,
                                             device=lists.device)])
    fill = cdiv(probe.shape[1], g) * g - probe.shape[1]
    if fill:
        probe = torch.cat([probe, torch.full((probe.shape[0], fill), nlist,
                                             dtype=probe.dtype,
                                             device=probe.device)], dim=1)
        extras = [torch.cat([e, torch.zeros((e.shape[0], fill),
                                            dtype=e.dtype, device=e.device)],
                            dim=1) for e in extras]
    return probe, lists_ext, extras


def probe_and_score(q: torch.Tensor, centroids: torch.Tensor,
                    lists: torch.Tensor, storage: torch.Tensor,
                    scorer: Scorer, params, sim: str, nprobe: int
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Route ``q`` to ``nprobe`` lists, gather and score every candidate.

    Returns ``(scores, cand, valid)``, each (Q, nprobe·max_len) in probe
    order: scores with pad slots at −inf, the candidate row ids (−1 pads)
    and the validity mask.  Lists are gathered ``PROBE_BLOCK`` at a time.
    """
    _, probe = route(q, centroids, sim, nprobe)
    qe = scorer.encode_queries(q)
    g = min(PROBE_BLOCK, nprobe)
    probe, lists_ext, _ = _pad_probe(probe, lists, [], g)
    n_q = q.shape[0]
    scores, cands = [], []
    for j0 in range(0, probe.shape[1], g):
        cand_j = lists_ext[probe[:, j0: j0 + g].long()].reshape(n_q, -1)
        gathered = storage[cand_j.clamp(min=0).long()]
        scores.append(scorer.scores_gathered(qe, gathered, params=params))
        cands.append(cand_j)
    width = nprobe * lists.shape[1]
    s = torch.cat(scores, dim=1)[:, :width]
    cand = torch.cat(cands, dim=1)[:, :width]
    valid = cand >= 0
    return torch.where(valid, s, NEG_INF), cand, valid


class _Staging:
    """Two host buffers that carry the tiered search's blocks to the device.

    On CUDA they are pinned and copied with ``non_blocking=True``, so the
    host assembles block j + 1 while block j's copy and kernels run; a
    buffer is refilled only after the event recorded behind its last copy
    has completed.  On the CPU the buffer is the block itself.
    """

    def __init__(self, device: torch.device):
        self.device = device
        self.pinned = device.type == "cuda"
        self._bufs: list[Optional[torch.Tensor]] = [None, None]
        self._events: list = [None, None]
        self._i = 0

    def take(self, nbytes: int) -> np.ndarray:
        """The next buffer as a uint8 array of at least ``nbytes``."""
        self._i = 1 - self._i
        if self._events[self._i] is not None:
            self._events[self._i].synchronize()   # its copy has landed
            self._events[self._i] = None
        buf = self._bufs[self._i]
        if buf is None or buf.numel() < nbytes:
            buf = self._bufs[self._i] = torch.empty(
                max(nbytes, 1 << 20), dtype=torch.uint8,
                pin_memory=self.pinned)
        return buf.numpy()

    def to_device(self, nbytes: int) -> torch.Tensor:
        """The first ``nbytes`` of the buffer just filled, on the device."""
        host = self._bufs[self._i][:nbytes]
        if not self.pinned:
            return host
        out = host.to(self.device, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        self._events[self._i] = event
        return out


def _align16(n: int) -> int:
    return cdiv(n, 16) * 16


def build_padded_lists(labels: np.ndarray, nlist: int) -> np.ndarray:
    """(n_docs,) cluster labels → (nlist, max_len) int32 id matrix, −1
    padded; doc ids ascend within each list (one stable argsort)."""
    order = np.argsort(labels, kind="stable").astype(np.int32)
    counts = np.bincount(labels, minlength=nlist)
    max_len = max(1, int(counts.max(initial=0)))
    lists = np.full((nlist, max_len), -1, np.int32)
    starts = np.concatenate([[0], np.cumsum(counts)])
    for c in range(nlist):
        b = order[starts[c]: starts[c + 1]]
        lists[c, : len(b)] = b
    return lists


class IVFIndex:
    """Quantized IVF index: coarse k-means router over scorer-backend storage.

    ``pipeline`` follows :class:`~repro_torch.retrieval.index.
    CompressedIndex`: float stages transform docs and queries, a trailing
    quantizer picks the storage; ``pipeline=None`` stores plain float.
    ``backend`` ∈ {"auto", "torch", "kernel"} (``repro``'s names map in).
    ``nprobe`` clamps to ``nlist`` at search time and can be given per
    call.  Everything lives on ``device`` (``None``: CUDA).
    """

    def __init__(self, pipeline: Optional[CompressionPipeline] = None,
                 nlist: int = 200, nprobe: int = 100, sim: str = "ip",
                 backend: str = "auto", kmeans_iters: int = 15,
                 residual: bool = False, kmeans_init: str = "random",
                 balanced: bool = False, device: DeviceLike = None):
        if nlist < 1:
            raise ValueError("nlist must be ≥ 1")
        if residual and sim != "ip":
            raise ValueError("residual encoding is IP-only: the routed "
                             "q·centroid correction is an inner-product "
                             f"identity (got sim={sim!r})")
        self.device = resolve_device(device)
        self.pipeline = pipeline if pipeline is not None \
            else CompressionPipeline([])
        self.nlist = nlist
        self._nlist_requested = nlist  # clamp is per-fit, never sticky
        self.nprobe = nprobe
        self.sim = sim
        self.backend = check_backend(backend)
        self.kmeans_iters = kmeans_iters
        self.residual = residual       # store encode(x − centroid[label])
        self.kmeans_init = kmeans_init
        self.balanced = balanced       # capacity-aware list assignment
        self.float_stages, self.scorer = scorer_for_pipeline(
            self.pipeline, sim=sim, backend=self.backend)
        self.centroids: Optional[torch.Tensor] = None  # (nlist, d) f32
        self.lists: Optional[torch.Tensor] = None      # (nlist, L) i32, −1 pad
        self.storage: Optional[torch.Tensor] = None    # scorer-encoded rows
        self.spec = None               # set by api.build_index / api.load_index
        self.store = None              # ListStore when tiered (storage=None)
        self._labels: Optional[np.ndarray] = None      # (n_docs,) cluster ids
        self._n_docs = 0
        self._dim = 0
        self._version = 0              # bumped on every fit/add
        self._source = None            # (CompressedIndex, version) when promoted
        self._list_layout = None       # lazy (version, list storage, ids)

    # -- construction -----------------------------------------------------
    @classmethod
    def build(cls, docs, queries_sample=None,
              pipeline: Optional[CompressionPipeline] = None, *,
              nlist: int = 200, nprobe: int = 100, sim: str = "ip",
              backend: str = "auto", kmeans_iters: int = 15,
              residual: bool = False, kmeans_init: str = "random",
              balanced: bool = False, rng: Optional[torch.Generator] = None,
              device: DeviceLike = None) -> "IVFIndex":
        """Fit the pipeline on ``docs``, then the IVF structure."""
        dev = resolve_device(device)
        docs = as_tensor(docs, dev)
        if queries_sample is not None:
            queries_sample = as_tensor(queries_sample, dev)
        pipeline = pipeline if pipeline is not None else CompressionPipeline([])
        pipeline.fit(docs, queries_sample, rng=rng)
        idx = cls(pipeline, nlist=nlist, nprobe=nprobe, sim=sim,
                  backend=backend, kmeans_iters=kmeans_iters,
                  residual=residual, kmeans_init=kmeans_init,
                  balanced=balanced, device=dev)
        return idx.fit(docs, rng=rng)

    def fit(self, docs, rng: Optional[torch.Generator] = None,
            train_size: int = 100_000) -> "IVFIndex":
        """Encode ``docs`` through the (fitted) pipeline and build the
        router and the inverted lists.  Routing needs the float rows, so
        the encode stays staged here (no one-pass ``fused_quantize``)."""
        x = apply_float_stages(self.float_stages,
                               as_tensor(docs, self.device), "docs")
        if self.residual:
            # route first, then store what the router cannot explain; the
            # routed q·centroid term is added back at scoring time
            x = x.float()
            if x.shape[0] == 0:
                raise ValueError("cannot fit an IVF index on an empty corpus")
            self._fit_router(x, rng=rng, train_size=train_size)
            res = x - self.centroids[
                torch.from_numpy(self._labels).to(self.device).long()]
            return self._finish_install(self.scorer.encode_docs(res), x)
        storage = self.scorer.encode_docs(x)
        return self._install(storage, x, rng=rng, train_size=train_size)

    def _fit_router(self, x_route: torch.Tensor,
                    rng: Optional[torch.Generator] = None,
                    train_size: int = 100_000) -> None:
        """k-means centroids and list assignment from float routing rows."""
        n_docs = int(x_route.shape[0])
        if rng is None:
            rng = torch.Generator().manual_seed(0)
        # clamp to this corpus from the *requested* nlist
        self.nlist = max(1, min(self._nlist_requested, n_docs))
        train = x_route
        if n_docs > train_size:
            sel = torch.randperm(n_docs, generator=rng, device=rng.device)
            train = x_route[sel[:train_size].to(x_route.device)]
        self.centroids = kmeans_fit(train, self.nlist, self.kmeans_iters,
                                    rng, init=self.kmeans_init)
        if self.balanced and n_docs > self.nlist:
            labels = assign_balanced(x_route, self.centroids)
        else:
            labels = assign(x_route, self.centroids)
        self._labels = labels.cpu().numpy().astype(np.int32)
        self.lists = torch.from_numpy(
            build_padded_lists(self._labels, self.nlist)).to(self.device)

    def _finish_install(self, storage: torch.Tensor,
                        x_route: torch.Tensor) -> "IVFIndex":
        self.storage = storage
        self._n_docs = int(storage.shape[0])
        self._dim = int(x_route.shape[-1])
        self._version += 1
        self._source = None    # fresh fit: no longer a shared-storage view
        self._list_layout = None
        self.store = None      # a fresh fit is fully resident
        return self

    def _install(self, storage: torch.Tensor, x_route: torch.Tensor,
                 rng: Optional[torch.Generator] = None,
                 train_size: int = 100_000) -> "IVFIndex":
        """Install pre-encoded ``storage`` with float routing rows
        ``x_route`` in the same order (``fit`` and ``to_ivf``)."""
        if self.residual:
            raise ValueError("residual IVF cannot adopt pre-encoded storage "
                             "(rows must be re-encoded against the routed "
                             "centroids) — use fit()")
        if int(storage.shape[0]) == 0:
            raise ValueError("cannot fit an IVF index on an empty corpus")
        self._fit_router(x_route.float(), rng=rng, train_size=train_size)
        return self._finish_install(storage, x_route)

    def _install_routed(self, storage: torch.Tensor, labels: np.ndarray,
                        centroids: torch.Tensor, dim: int) -> "IVFIndex":
        """Adopt storage already routed to an existing router: no k-means
        refit, only the list table is rebuilt."""
        if self.residual:
            raise ValueError("residual IVF cannot adopt pre-encoded storage")
        storage = as_tensor(storage, self.device)
        if storage.shape[0] == 0:
            raise ValueError("cannot install an empty corpus")
        self.centroids = as_tensor(centroids, self.device).float()
        self.nlist = int(self.centroids.shape[0])
        self._labels = np.asarray(labels).astype(np.int32)
        if self._labels.shape != (int(storage.shape[0]),):
            raise ValueError("labels must be one cluster id per storage row")
        self.lists = torch.from_numpy(
            build_padded_lists(self._labels, self.nlist)).to(self.device)
        return self._finish_install(storage, torch.zeros((0, dim)))

    def add(self, docs) -> "IVFIndex":
        """Append docs, routed to the *existing* centroids (no refit); the
        encode is staged, as in :meth:`fit`, for the float routing rows."""
        if self.store is not None:
            raise ValueError(
                "store-backed (tiered) IVF index is read-only — wrap it in "
                "a SegmentedIndex for live updates, or reload with "
                "resident='all'")
        if self.centroids is None:
            return self.fit(docs)
        x = apply_float_stages(self.float_stages,
                               as_tensor(docs, self.device), "docs")
        x_f = x.float()
        labels = assign(x_f, self.centroids)
        if self.residual:
            enc = self.scorer.encode_docs(x_f - self.centroids[labels])
        else:
            enc = self.scorer.encode_docs(x)
        self.storage = torch.cat([self.storage, enc])
        self._labels = np.concatenate(
            [self._labels, labels.cpu().numpy().astype(np.int32)])
        self.lists = torch.from_numpy(
            build_padded_lists(self._labels, self.nlist)).to(self.device)
        self._n_docs = int(self.storage.shape[0])
        self._version += 1
        self._source = None    # storage was copied on append: now our own
        self._list_layout = None
        return self

    def __len__(self) -> int:
        return self._n_docs

    @property
    def nbytes(self) -> int:
        """Bytes of the quantized document storage (the paper's metric);
        for a store-backed index the encoded artifact's size, what a fully
        resident load would hold (``store.stats()["bytes_resident"]`` is
        the hot tier's)."""
        if self.storage is not None:
            return self.storage.numel() * self.storage.element_size()
        if self.store is not None:
            return int(self.store.encoded_nbytes)
        raise ValueError("index is empty")

    @property
    def aux_nbytes(self) -> int:
        """Routing overhead: centroids and padded lists, plus the
        list-major storage copy once the fused path has built it."""
        parts = [self.centroids, self.lists]
        if self._list_layout is not None:
            parts.append(self._list_layout[1])
        return sum(a.numel() * a.element_size() for a in parts
                   if a is not None)

    # -- search ------------------------------------------------------------
    def encode_queries(self, queries) -> torch.Tensor:
        """Queries through the float stages (no query-side quantization)."""
        return apply_float_stages(self.float_stages,
                                  as_tensor(queries, self.device), "queries")

    @property
    def _use_fused_kernel(self) -> bool:
        """Search through the fused ``ivf_fused`` kernel?

        It serves the inner product for all four storage formats with
        kernel numerics; 1-bit only at the paper's offset 0.5 (another
        offset has rank-1 terms the kernel does not add).  Everything else
        streams.  Decided by the backend and the device, so that a
        store-backed index takes the same route, a probe block at a time.
        """
        if not use_kernel(self.scorer.backend, self.device) \
                or self.sim != "ip":
            return False
        if self.scorer.name == "onebit":
            return float(self.scorer.quantizer.offset) == 0.5
        return True

    def _list_major_layout(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(nlist, max_len, w) list-major storage and its (nlist, max_len)
        ids, pad rows zeroed.  Built on the first fused search and cached
        against the index version (counted in :attr:`aux_nbytes`); the
        row-major ``storage`` stays the source of truth."""
        if self._list_layout is not None and \
                self._list_layout[0] == self._version:
            return self._list_layout[1], self._list_layout[2]
        list_storage = self.storage[self.lists.clamp(min=0).long()]
        list_storage.masked_fill_((self.lists < 0)[..., None], 0)
        self._list_layout = (self._version, list_storage, self.lists)
        return list_storage, self.lists

    def _streaming_search(self, queries: torch.Tensor, k: int, nprobe: int,
                          params: dict) -> tuple[torch.Tensor, torch.Tensor]:
        """Route, then gather → score → merge ``PROBE_BLOCK`` lists a step."""
        q = self.encode_queries(queries)
        cvals, probe = route(q, self.centroids, self.sim, nprobe)
        qe = self.scorer.encode_queries(q)
        n_q, max_len = q.shape[0], self.lists.shape[1]
        g = min(PROBE_BLOCK, nprobe)
        probe, lists_ext, (cvals,) = _pad_probe(probe, self.lists, [cvals], g)
        vals = torch.full((n_q, k), NEG_INF, device=q.device)
        ids = torch.full((n_q, k), -1, dtype=torch.int32, device=q.device)
        for j0 in range(0, probe.shape[1], g):
            cand_j = lists_ext[probe[:, j0: j0 + g].long()].reshape(n_q, -1)
            gathered = self.storage[cand_j.clamp(min=0).long()]
            s_j = self.scorer.scores_gathered(qe, gathered, params=params)
            if self.residual:              # routed q·centroid term
                s_j = s_j + cvals[:, j0: j0 + g].repeat_interleave(
                    max_len, dim=1)
            s_j = torch.where(cand_j >= 0, s_j, NEG_INF)
            vals, ids = merge_topk_block(
                vals, ids, s_j, torch.where(cand_j >= 0, cand_j, -1), k)
        return vals, ids

    def _fused_search(self, queries: torch.Tensor, k: int, nprobe: int,
                      params: dict, list_storage: torch.Tensor,
                      list_ids: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
        """Route, then one fused gather + score + top-k kernel launch."""
        from repro_torch.kernels.ivf_fused import ops as fused_ops
        q = self.encode_queries(queries).float()
        cvals, probe = route(q, self.centroids, self.sim, nprobe)
        return fused_ops.fused_ivf_topk(
            probe, q, list_storage, list_ids, k, self.scorer.name,
            params=params, extra_base=cvals if self.residual else None)

    def search(self, queries, k: int, nprobe: Optional[int] = None,
               query_chunk: int = 64) -> tuple[torch.Tensor, torch.Tensor]:
        """Top-``min(k, n_docs)`` over the probed lists, int64 ids.

        Slots no probed list can fill come back as (−inf, −1); with
        ``nprobe == nlist`` every doc is reachable and the ranking is
        exact search's.  ``query_chunk`` bounds the streaming path's
        gathered block; the fused path takes the batch whole (each list
        is read once for all the queries that probe it; the kernel's
        wrapper bounds its own buffers).  A store-backed index walks the
        queries ``query_chunk`` at a time, as ``repro`` does.
        """
        if self.storage is None and self.store is None:
            raise ValueError("IVFIndex is not fitted")
        if self._source is not None and \
                self._source[0]._version != self._source[1]:
            raise ValueError(
                "source CompressedIndex changed since to_ivf (add was "
                "called); the promoted IVF view shares its old storage — "
                "re-promote with to_ivf()")
        nprobe = resolve_nprobe(nprobe, self.nlist, default=self.nprobe)
        k = resolve_k(k, self._n_docs)
        queries = as_tensor(queries, self.device)
        params = self.scorer.params()
        if self.storage is None:       # tiered: lists come from the store
            vals, ids = self._store_search(queries, k, nprobe, query_chunk,
                                           params)
            return vals, ids.long()
        if self._use_fused_kernel:
            vals, ids = self._fused_search(queries, k, nprobe, params,
                                           *self._list_major_layout())
            return vals, ids.long()
        vals, ids = [], []
        for s in range(0, queries.shape[0], query_chunk):
            v, i = self._streaming_search(queries[s: s + query_chunk], k,
                                          nprobe, params)
            vals.append(v)
            ids.append(i)
        return torch.cat(vals), torch.cat(ids).long()

    # -- tiered (store-backed) search --------------------------------------
    def _fetch_block(self, pj: np.ndarray
                     ) -> tuple[list[tuple[np.ndarray, np.ndarray]],
                                np.ndarray]:
        """One probe block's lists from the store: ``pj`` is the (Q, g)
        slice of the probe table (phantom pad slots carry ``nlist``).

        Each distinct list is fetched once, in first-touch order over the
        queries then the slots — ``repro``'s ``_gather_block`` order, so
        the store counts the same touches.  Returns the fetched
        ``(rows, ids)`` in the port's dtypes and the (Q, g) slot → fetched
        position map, ``len(fetched)`` at phantom slots.
        """
        flat = pj.ravel()
        uniq, first, inv = np.unique(flat, return_index=True,
                                     return_inverse=True)
        order = np.argsort(first, kind="stable")       # first-touch order
        real = uniq[order] < self.nlist
        lids = uniq[order][real]
        fetched = []
        for lid in lids.tolist():
            rows, ids = self.store.get(lid)
            fetched.append((port_rows(rows), ids))
        pos = np.where(real, np.cumsum(real) - 1, len(lids))
        rank = np.empty(len(uniq), np.int64)
        rank[order] = np.arange(len(uniq))
        return fetched, pos[rank[inv.ravel()]].reshape(pj.shape)

    def _assemble_block(self, staging: _Staging, fetched, local: np.ndarray,
                        max_len: int, dtype: np.dtype
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Stack a block's fetched lists into a block-local list-major
        ``(n + 1, L, w)`` storage and ``(n + 1, L)`` ids on the device; the
        last list is empty (the phantom pad slots' list), pad rows are zero
        with id −1.  The rows travel packed — no pad bytes — in one copy,
        with the list starts and lengths and the (Q, g) local probe table;
        the padded layout is gathered on the device.  Returns (storage,
        ids, local probes)."""
        n_lists = len(fetched)
        w = self.store.storage_width
        lens = np.array([len(ids) for _, ids in fetched] + [0], np.int32)
        total = int(lens.sum())
        starts = np.zeros(n_lists + 1, np.int32)
        np.cumsum(lens[:-1], out=starts[1:])
        n_rows_b = (total + 1) * w * dtype.itemsize     # + one zero row
        o_ids = _align16(n_rows_b)
        o_starts = o_ids + _align16((total + 1) * 4)
        o_lens = o_starts + _align16((n_lists + 1) * 4)
        o_probes = o_lens + _align16((n_lists + 1) * 4)
        nbytes = o_probes + local.size * 4
        buf = staging.take(nbytes)
        rows_h = buf[:n_rows_b].view(dtype).reshape(total + 1, w)
        ids_h = buf[o_ids: o_ids + (total + 1) * 4].view(np.int32)
        for (rows, ids), lo, n in zip(fetched, starts, lens):
            rows_h[lo: lo + n] = rows           # copies out of the map
            ids_h[lo: lo + n] = ids
        rows_h[total] = 0
        ids_h[total] = -1
        buf[o_starts: o_starts + starts.nbytes] = starts.view(np.uint8)
        buf[o_lens: o_lens + lens.nbytes] = lens.view(np.uint8)
        buf[o_probes: nbytes] = local.astype(np.int32).ravel().view(np.uint8)
        dev = staging.to_device(nbytes)
        rows_d = dev[:n_rows_b].view(torch.from_numpy(rows_h[:0]).dtype) \
            .view(total + 1, w)
        ids_d = dev[o_ids: o_ids + (total + 1) * 4].view(torch.int32)
        starts_d = dev[o_starts: o_starts + starts.nbytes].view(torch.int32)
        lens_d = dev[o_lens: o_lens + lens.nbytes].view(torch.int32)
        probes_d = dev[o_probes: nbytes].view(torch.int32).view(local.shape)
        ar = torch.arange(max_len, dtype=torch.int32, device=self.device)
        index = torch.where(ar[None, :] < lens_d[:, None],
                            starts_d[:, None] + ar[None, :], total).long()
        return rows_d[index], ids_d[index], probes_d

    def _gather_block(self, fetched, local: np.ndarray, g: int, max_len: int,
                      dtype: np.dtype) -> tuple[torch.Tensor, torch.Tensor]:
        """The streaming route's block: the zero-filled ``(Q, g·L, w)``
        gathered rows and −1-filled ``(Q, g·L)`` candidate ids, on the
        device."""
        n_q = local.shape[0]
        gathered = np.zeros((n_q, g * max_len, self.store.storage_width),
                            dtype)
        cand = np.full((n_q, g * max_len), -1, np.int32)
        for qi in range(n_q):
            for j in range(g):
                p = int(local[qi, j])
                if p == len(fetched):          # phantom pad slot
                    continue
                rows, ids = fetched[p]
                n = ids.shape[0]
                gathered[qi, j * max_len: j * max_len + n] = rows
                cand[qi, j * max_len: j * max_len + n] = ids
        return (torch.from_numpy(gathered).to(self.device),
                torch.from_numpy(cand).to(self.device))

    def _store_search(self, queries: torch.Tensor, k: int, nprobe: int,
                      query_chunk: int, params: dict
                      ) -> tuple[torch.Tensor, torch.Tensor]:
        """Search with list bytes served by :attr:`store`, ``PROBE_BLOCK``
        probe slots a step, the queries ``query_chunk`` at a time."""
        from repro_torch.kernels.ivf_fused import kernel as fused_kernel
        from repro_torch.kernels.ivf_fused.ops import prepare_queries
        max_len = max(1, int(self.store.max_len))
        g = min(PROBE_BLOCK, nprobe)
        npad = cdiv(nprobe, g) * g             # phantom pad slots, as repro
        dtype = port_rows(np.empty(0, self.store.storage_dtype)).dtype
        fused = self._use_fused_kernel
        if fused:
            # route the batch whole, as the resident fused search does, so
            # the encoded queries, bases and probes carry the same bits
            q = self.encode_queries(queries).float()
            cvals, probe = route(q, self.centroids, self.sim, nprobe)
            w = self.store.storage_width
            qe, base_q = prepare_queries(
                q, self.scorer.name, params,
                packed_width=w if self.scorer.name == "onebit" else None)
            cvals = F.pad(cvals, (0, npad - nprobe))
            probe_np = probe.cpu().numpy()
            staging = _Staging(self.device)
        vals_out, ids_out = [], []
        for s in range(0, queries.shape[0], query_chunk):
            e = min(s + query_chunk, queries.shape[0])
            if fused:
                probe_c = probe_np[s:e]
            else:
                q = self.encode_queries(queries[s:e])
                cvals, probe = route(q, self.centroids, self.sim, nprobe)
                qe = self.scorer.encode_queries(q)
                cvals = F.pad(cvals, (0, npad - nprobe))
                probe_c = probe.cpu().numpy()
            probe_c = np.pad(probe_c, ((0, 0), (0, npad - nprobe)),
                             constant_values=self.nlist)
            n_q = e - s
            rv = torch.full((n_q, k), NEG_INF, device=self.device)
            ri = torch.full((n_q, k), -1, dtype=torch.int32,
                            device=self.device)
            for j0 in range(0, npad, g):
                fetched, local = self._fetch_block(probe_c[:, j0: j0 + g])
                if fused:
                    stor_b, ids_b, probes_b = self._assemble_block(
                        staging, fetched, local, max_len, dtype)
                    base = base_q[s:e, None].expand(n_q, g).float()
                    if self.residual:
                        base = base + cvals[s:e, j0: j0 + g].float()
                    v, i = fused_kernel.fused_ivf_topk(
                        probes_b, qe[s:e], stor_b, ids_b, base, k,
                        self.scorer.name)
                    # exact under the total order, in a fixed number of
                    # launches (merge_topk_block's k rounds cost ~9 a round)
                    rv, ri = masked_topk_by_id(torch.cat([rv, v], dim=1),
                                               torch.cat([ri, i], dim=1), k)
                else:
                    gathered, cand = self._gather_block(fetched, local, g,
                                                        max_len, dtype)
                    v = self.scorer.scores_gathered(qe, gathered,
                                                    params=params)
                    if self.residual:          # routed q·centroid term
                        v = v + cvals[:, j0: j0 + g].repeat_interleave(
                            max_len, dim=1)
                    rv, ri = merge_topk_block(
                        rv, ri, torch.where(cand >= 0, v, NEG_INF),
                        torch.where(cand >= 0, cand, -1), k)
            vals_out.append(rv)
            ids_out.append(ri)
        return torch.cat(vals_out), torch.cat(ids_out)

    def iter_lists(self):
        """``(list_id, rows, ids)`` for every inverted list in id order, on
        the host, rows in the artifact's dtype (1-bit words as uint32):
        straight off the store for a tiered index (its hot tier
        untouched), else from the resident storage — the walk of a chunked
        save and of a compaction's fold."""
        if self.store is not None:
            yield from self.store.iter_lists()
            return
        lists_np = self.lists.cpu().numpy()
        storage_np = artifact_rows(self.storage.cpu().numpy())
        for lid in range(self.nlist):
            members = lists_np[lid]
            members = members[members >= 0]
            yield lid, storage_np[members], members

    def prefetch(self, queries, nprobe: Optional[int] = None) -> int:
        """Warm a store-backed index's hot tier with the probe table for
        ``queries`` (route only, no scoring); returns the lists touched —
        0 on a fully resident index."""
        if self.store is None:
            return 0
        nprobe = resolve_nprobe(nprobe, self.nlist, default=self.nprobe)
        q = self.encode_queries(queries)
        _, probe = route(q, self.centroids, self.sim, nprobe)
        lids = np.unique(probe.cpu().numpy().ravel())
        return self.store.prefetch(lids[lids < self.nlist].tolist())

    # -- persistence -------------------------------------------------------
    def state_dict(self) -> dict:
        """Pipeline, storage, router and list layout: the whole artifact."""
        if self.storage is None and self.store is not None:
            raise ValueError(
                "store-backed (tiered) IVF index has no resident storage to "
                "snapshot — save_index(..., chunked=True) streams it from "
                "the store, or reload with resident='all' first")
        return {"pipeline": self.pipeline.state_dict(),
                "storage": self.storage,
                "centroids": self.centroids,
                "lists": self.lists,
                "labels": self._labels,
                "scorer_extra": self.scorer.extra_state(),
                "nlist": self.nlist,
                "nlist_requested": self._nlist_requested,
                "nprobe": self.nprobe,
                "residual": self.residual,
                "kmeans_init": self.kmeans_init,
                "balanced": self.balanced,
                "n_docs": self._n_docs, "dim": self._dim,
                "version": self._version}

    def load_state_dict(self, sd: dict) -> "IVFIndex":
        """Load state from tensors or numpy arrays (``repro``'s artifacts).
        ``storage`` and ``lists`` are None for a tiered load: the caller
        attaches the store afterwards (``api._load_index_chunked``)."""
        self.pipeline.load_state_dict(sd["pipeline"], self.device)
        storage, lists = sd["storage"], sd["lists"]
        self.storage = (storage_tensor(storage, self.device)
                        if storage is not None else None)
        self.centroids = as_tensor(sd["centroids"], self.device).float()
        self.lists = (as_tensor(lists, self.device).to(torch.int32)
                      if lists is not None else None)
        labels = sd.get("labels")
        self._labels = (np.asarray(labels).astype(np.int32)
                        if labels is not None else None)
        self.scorer.load_extra_state(sd.get("scorer_extra", {}))
        self.nlist = int(sd["nlist"])
        self._nlist_requested = int(sd.get("nlist_requested", sd["nlist"]))
        self.nprobe = int(sd["nprobe"])
        self.residual = bool(sd.get("residual", False))
        self.kmeans_init = str(sd.get("kmeans_init", "random"))
        self.balanced = bool(sd.get("balanced", False))
        self._n_docs = int(sd["n_docs"])
        self._dim = int(sd["dim"])
        self._version = int(sd.get("version", 0))
        self._source = None            # an artifact owns its storage
        self._list_layout = None
        self.store = None
        return self

    def save(self, path: str) -> None:
        from repro_torch.retrieval.api import save_index
        save_index(self, path)

    @classmethod
    def load(cls, path: str, device: DeviceLike = None) -> "IVFIndex":
        from repro_torch.retrieval.api import load_index
        return load_index(path, expect=cls, device=device)


class IVFFlatIndex(IVFIndex):
    """Float-storage IVF (FAISS ``IndexIVFFlat``'s analogue): no
    compression pipeline, plain-torch scoring."""

    def __init__(self, nlist: int = 200, nprobe: int = 100, sim: str = "ip",
                 kmeans_iters: int = 15, kmeans_init: str = "random",
                 balanced: bool = False, device: DeviceLike = None):
        super().__init__(None, nlist=nlist, nprobe=nprobe, sim=sim,
                         backend="torch", kmeans_iters=kmeans_iters,
                         kmeans_init=kmeans_init, balanced=balanced,
                         device=device)

    @property
    def docs(self) -> Optional[torch.Tensor]:
        return self.storage
