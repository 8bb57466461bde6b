"""Online shadow scoring: validate compressed-serving quality in production.

A :class:`ShadowScorer` holds an exact-search index over the float view of
the corpus and re-scores a sampled fraction of served batches, tracking the
running top-k overlap between the production (quantized) rankings and the
exact ones — the standard deployment-validation pattern: quality regressions
(a bad codebook refresh, a corrupted shard) surface as an overlap drop
within minutes, without doubling serving cost.

The same mechanism doubles as the hot-swap **canary**: pass any *staged*
index (``ShadowScorer(staged_index, every=N)``) and attach it to the live
engine's observers — the overlap then measures how far the next version's
rankings drift from what live traffic is being served today, which is what
``RetrievalService.promote(min_overlap=...)`` gates on.  Any object with
``search(queries, k)`` works as the reference; the ``DenseIndex`` hint is
just the common exact-search case.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.preprocess import as_tensor
from repro_torch.retrieval.index import CompressedIndex, DenseIndex
from repro_torch.retrieval.rprecision import recall_at_k


def to_host(x) -> np.ndarray:
    """A search result on the host: a tensor on any device, or an array."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class ShadowScorer:
    """Samples 1/``every`` batches; re-scores them on an exact index.

    ``encode`` maps raw request queries into the shadow index's space
    (identity for a dense shadow over raw embeddings; the float pipeline
    stages for a compressed production index).
    """

    def __init__(self, index: DenseIndex, every: int = 5,
                 encode: Optional[Callable] = None):
        if every < 1:
            raise ValueError("every must be ≥ 1")
        self.index = index
        self.every = every
        self.encode = encode
        self._batches_seen = 0
        self.overlaps: list[float] = []

    @classmethod
    def for_compressed(cls, index: CompressedIndex, docs, every: int = 5
                       ) -> "ShadowScorer":
        """Shadow for a compressed index: exact search in its float space.

        The asymmetric oracle — documents through the pipeline's float
        stages (doc statistics), queries through the same stages (query
        statistics), scored at full precision.
        """
        from repro_torch.retrieval.scorers import apply_float_stages
        x = apply_float_stages(index.float_stages,
                               as_tensor(docs, index.device), "docs")
        return cls(DenseIndex(x, sim=index.sim, device=index.device),
                   every=every, encode=index.encode_queries)

    def observe(self, queries: np.ndarray, ids: np.ndarray, k: int
                ) -> Optional[float]:
        """Maybe shadow-score one served batch; returns overlap if sampled."""
        self._batches_seen += 1
        if (self._batches_seen - 1) % self.every != 0:
            return None
        q = self.encode(queries) if self.encode is not None else queries
        _, want = self.index.search(q, k)
        want = to_host(want)
        got = to_host(ids)
        k_eff = min(k, got.shape[1], want.shape[1])  # search clamps k to n_docs
        overlap = recall_at_k(got[:, :k_eff], want[:, :k_eff])
        self.overlaps.append(overlap)
        return overlap

    @property
    def mean_overlap(self) -> float:
        return float(np.mean(self.overlaps)) if self.overlaps else float("nan")
