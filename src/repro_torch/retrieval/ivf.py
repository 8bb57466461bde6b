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

Routing ranks the (Q, nlist) centroid scores with ``topk_score_then_id``,
which gives ``lax.top_k``'s lowest-index-first order.  ``fit`` clamps the
effective ``nlist`` to the corpus size (a cluster that k-means leaves
empty is an all-pad list); ``search`` returns ``min(k, n_docs)`` columns,
with (−inf, −1) in slots no probed list can fill.  Store-backed (tiered)
search waits for the storage slice of the port (ROADMAP A.9): every index
here is fully resident.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.pipeline import CompressionPipeline
from repro_torch.core.preprocess import as_tensor
from repro_torch.retrieval.index import storage_tensor
from repro_torch.retrieval.kmeans import assign, assign_balanced, kmeans_fit
from repro_torch.retrieval.scorers import (Scorer, apply_float_stages,
                                           scorer_for_pipeline)
from repro_torch.retrieval.topk import (NEG_INF, merge_topk_block, resolve_k,
                                        resolve_nprobe, similarity,
                                        topk_score_then_id)
from repro_torch.utils import (STORAGE_SLICE, DeviceLike, check_backend,
                               cdiv, resolve_device)

__all__ = ["IVFIndex", "IVFFlatIndex", "build_padded_lists",
           "probe_and_score", "route"]

#: probed lists gathered and scored per streaming step; the merge is
#: associative under the strict order, so any grouping ranks the same
PROBE_BLOCK = 2


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
        self.store = None              # tiered list store: the storage slice
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
        """Bytes of the quantized document storage (the paper's metric)."""
        if self.storage is None:
            raise ValueError("index is empty")
        return self.storage.numel() * self.storage.element_size()

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
        streams.
        """
        if not self.scorer.use_kernel(self.storage) or self.sim != "ip":
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
        wrapper bounds its own buffers).
        """
        if self.storage is None:
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

    def prefetch(self, queries, nprobe: Optional[int] = None) -> int:
        """Warm a store-backed index's hot tier with the probe table for
        ``queries``; returns the lists touched — 0 on a fully resident
        index, which every index of the port is."""
        if self.store is None:
            return 0
        raise NotImplementedError(
            f"store-backed IVF search (prefetch) waits for {STORAGE_SLICE}")

    # -- persistence -------------------------------------------------------
    def state_dict(self) -> dict:
        """Pipeline, storage, router and list layout: the whole artifact."""
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
        """Load state from tensors or numpy arrays (``repro``'s artifacts)."""
        self.pipeline.load_state_dict(sd["pipeline"], self.device)
        self.storage = storage_tensor(sd["storage"], self.device)
        self.centroids = as_tensor(sd["centroids"], self.device).float()
        self.lists = as_tensor(sd["lists"], self.device).to(torch.int32)
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
