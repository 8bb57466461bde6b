"""Dense and compressed KB indexes (exact search).

Counterpart of ``repro.retrieval.index``.  :class:`DenseIndex` is the
uncompressed baseline; :class:`CompressedIndex` applies a fitted
:class:`~repro_torch.core.pipeline.CompressionPipeline` and stores the
encoded representation (fp16 / uint8 codes / packed sign words), scored
through the :mod:`~repro_torch.retrieval.scorers` backends, and promotes
to IVF search over the same storage with :meth:`CompressedIndex.to_ivf`.

Both live on one device, given at construction (``None`` means CUDA;
without a CUDA device pass ``device="cpu"``).  Quantized search runs in
query chunks: per chunk the float query stages, the query encoding, the
scoring kernel and the two-stage top-k, so a (chunk, D) score matrix is
the largest buffer.
"""

from __future__ import annotations

import copy
from typing import Optional

import torch

from repro_torch import tracing
from repro_torch.core.pipeline import CompressionPipeline
from repro_torch.core.preprocess import as_tensor
from repro_torch.core.quantization import words_from_numpy
from repro_torch.retrieval.scorers import (Scorer, apply_float_stages,
                                           encode_storage,
                                           scorer_for_pipeline)
from repro_torch.retrieval.topk import _exact_topk, resolve_k, topk_search
from repro_torch.utils import (DeviceLike, check_backend, chunked,
                               resolve_device)

#: queries scored per step on the quantized path: bounds the (Q, D) matrix
QUERY_CHUNK = 1024


def storage_tensor(x, device: torch.device) -> torch.Tensor:
    """Storage from a tensor or a numpy array (``repro``'s uint32 words
    become int32 with the same bytes)."""
    if not isinstance(x, torch.Tensor) and getattr(x, "dtype", None) == "uint32":
        return words_from_numpy(x).to(device)
    return as_tensor(x, device)


class DenseIndex:
    """Flat exact-search index over float vectors.

    ``backend`` picks the top-k path only: kernel (``topk_blocks``) or
    plain torch; both give the same ranking.
    """

    def __init__(self, docs, sim: str = "ip", device: DeviceLike = None,
                 backend: str = "auto"):
        self.device = resolve_device(device)
        self.docs = as_tensor(docs, self.device)
        self.sim = sim
        self.backend = check_backend(backend)
        self.spec = None               # set by api.build_index / api.load_index

    def __len__(self) -> int:
        return int(self.docs.shape[0])

    @property
    def nbytes(self) -> int:
        return self.docs.numel() * self.docs.element_size()

    def search(self, queries, k: int, doc_chunk: int = 131072
               ) -> tuple[torch.Tensor, torch.Tensor]:
        k = resolve_k(k, len(self))
        return topk_search(as_tensor(queries, self.device), self.docs, k,
                           sim=self.sim, doc_chunk=doc_chunk,
                           backend=self.backend)

    def add(self, docs) -> "DenseIndex":
        self.docs = torch.cat([self.docs, as_tensor(docs, self.device)])
        return self

    def state_dict(self) -> dict:
        return {"docs": self.docs}

    def load_state_dict(self, sd: dict) -> "DenseIndex":
        self.docs = as_tensor(sd["docs"], self.device)
        return self

    def save(self, path: str) -> None:
        from repro_torch.retrieval.api import save_index
        save_index(self, path)

    @classmethod
    def load(cls, path: str, device: DeviceLike = None) -> "DenseIndex":
        from repro_torch.retrieval.api import load_index
        return load_index(path, expect=cls, device=device)


class CompressedIndex:
    """Thin orchestrator: float pipeline stages + a scorer backend.

    ``backend`` ∈ {"auto", "torch", "kernel"} (``repro``'s "jnp"/"pallas"
    are accepted and mapped): which numerics score the quantized storage.
    """

    def __init__(self, pipeline: CompressionPipeline, sim: str = "ip",
                 backend: str = "auto", device: DeviceLike = None):
        self.device = resolve_device(device)
        self.pipeline = pipeline
        self.sim = sim
        self.backend = check_backend(backend)
        self.float_stages, self.scorer = scorer_for_pipeline(
            pipeline, sim=sim, backend=self.backend)
        self.storage: Optional[torch.Tensor] = None
        self.spec = None               # set by api.build_index / api.load_index
        self._n_docs = 0
        self._dim = 0
        self._version = 0
        self._decoded_cache: Optional[torch.Tensor] = None

    @classmethod
    def build(cls, docs, queries_sample, pipeline: CompressionPipeline,
              sim: str = "ip", backend: str = "auto",
              rng: Optional[torch.Generator] = None,
              device: DeviceLike = None) -> "CompressedIndex":
        """Fit ``pipeline`` on the corpus, then encode it into an index."""
        dev = resolve_device(device)
        docs = as_tensor(docs, dev)
        if queries_sample is not None:
            queries_sample = as_tensor(queries_sample, dev)
        pipeline.fit(docs, queries_sample, rng=rng)
        idx = cls(pipeline, sim=sim, backend=backend, device=dev)
        idx.add(docs)
        return idx

    def add(self, docs) -> "CompressedIndex":
        enc, self._dim = encode_storage(self.float_stages, self.scorer,
                                        as_tensor(docs, self.device))
        self.storage = (enc if self.storage is None
                        else torch.cat([self.storage, enc]))
        self._n_docs = int(self.storage.shape[0])
        self._version += 1
        self._decoded_cache = None     # storage changed: drop the float view
        return self

    def __len__(self) -> int:
        return self._n_docs

    @property
    def nbytes(self) -> int:
        if self.storage is None:
            raise ValueError("index is empty")
        return self.storage.numel() * self.storage.element_size()

    def encode_queries(self, queries) -> torch.Tensor:
        """Queries through the float stages (no query-side quantization)."""
        return apply_float_stages(self.float_stages,
                                  as_tensor(queries, self.device), "queries")

    def decoded_docs(self) -> torch.Tensor:
        """Float view of the storage, decoded once and cached (float and
        fp16 storage only; ``nbytes`` reports the storage alone)."""
        if type(self.scorer) is Scorer:
            return self.storage
        if self._decoded_cache is None:
            self._decoded_cache = self.scorer.decode(self.storage)
        return self._decoded_cache

    def to_ivf(self, nlist: int = 200, nprobe: int = 100, docs=None,
               kmeans_iters: int = 15, rng: Optional[torch.Generator] = None,
               train_size: int = 100_000):
        """Promote this index to IVF search over the *same* storage.

        The fitted stages and the storage are shared, the scorer is
        deep-copied (``encode_docs`` mutates it).  The router is fitted on
        the float decode of the storage, or on ``docs`` (the indexed
        corpus, in order) when given.  A later ``add`` here makes the IVF
        view's ``search`` raise.
        """
        from repro_torch.retrieval.ivf import IVFIndex

        if self.storage is None:
            raise ValueError("index is empty — add docs before to_ivf")
        ivf = IVFIndex(self.pipeline, nlist=nlist, nprobe=nprobe,
                       sim=self.sim, backend=self.backend,
                       kmeans_iters=kmeans_iters, device=self.device)
        ivf.float_stages = self.float_stages
        ivf.scorer = copy.deepcopy(self.scorer)
        if docs is not None:
            x_route = apply_float_stages(self.float_stages,
                                         as_tensor(docs, self.device), "docs")
            if int(x_route.shape[0]) != self._n_docs:
                raise ValueError("docs must be the indexed corpus "
                                 f"({self._n_docs} rows), got "
                                 f"{int(x_route.shape[0])}")
        elif self.scorer.name in ("float", "fp16"):
            x_route = self.decoded_docs()   # exact search reuses this cache
        else:
            # a routing temporary, not a cache: int8/1-bit search never
            # reads the float view
            x_route = self.scorer.decode(self.storage)
        ivf._install(self.storage, x_route, rng=rng, train_size=train_size)
        ivf._source = (self, self._version)
        return ivf

    def search(self, queries, k: int, doc_chunk: int = 131072
               ) -> tuple[torch.Tensor, torch.Tensor]:
        k = resolve_k(k, self._n_docs)
        if self.scorer.name in ("float", "fp16"):
            # float storage: stream the (cached) float view in doc chunks
            return topk_search(self.encode_queries(queries),
                               self.decoded_docs(), k, sim=self.sim,
                               doc_chunk=doc_chunk, backend=self.backend)
        with tracing.span("search"):
            queries = as_tensor(queries, self.device)
            tracing.count("search.queries", queries.shape[0])
            params = self.scorer.params()
            # encoded by chunk: a query-side product's bits may depend on
            # its row count, and the sharded index encodes the same chunks
            enc = [self.scorer.encode_queries(
                self.encode_queries(queries[s:e]))
                for s, e in chunked(queries.shape[0], QUERY_CHUNK)]
            q = enc[0] if len(enc) == 1 else torch.cat(enc)
            return _exact_topk(  # the whole storage is one block
                lambda qc, d: self.scorer.scores(qc, d, params=params),
                (q,), self.storage, k,
                kernel=self.scorer.use_kernel(self.storage),
                query_chunk=QUERY_CHUNK, doc_chunk=self._n_docs)

    def state_dict(self) -> dict:
        """Pipeline state (incl. scorer codebooks), the encoded storage and
        the bookkeeping counters."""
        return {"pipeline": self.pipeline.state_dict(),
                "storage": self.storage,
                "scorer_extra": self.scorer.extra_state(),
                "n_docs": self._n_docs, "dim": self._dim,
                "version": self._version}

    def load_state_dict(self, sd: dict) -> "CompressedIndex":
        """Load state from tensors or numpy arrays (``repro``'s artifacts)."""
        self.pipeline.load_state_dict(sd["pipeline"], self.device)
        # the scorer holds the same quantizer object as the pipeline's
        # trailing stage, so its codebooks are now loaded too
        self.storage = storage_tensor(sd["storage"], self.device)
        self.scorer.load_extra_state(sd.get("scorer_extra", {}))
        self._n_docs = int(sd["n_docs"])
        self._dim = int(sd["dim"])
        self._version = int(sd.get("version", 0))
        self._decoded_cache = None
        return self

    def save(self, path: str) -> None:
        from repro_torch.retrieval.api import save_index
        save_index(self, path)

    @classmethod
    def load(cls, path: str, device: DeviceLike = None) -> "CompressedIndex":
        from repro_torch.retrieval.api import load_index
        return load_index(path, expect=cls, device=device)
