"""R-Precision evaluation (paper §3.1, following Petroni et al. 2021).

For query q with r(q) relevant documents, R-Precision is
``|relevant ∩ top-r(q) retrieved| / r(q)``, averaged over queries.
Relevance is a padded ``(Q, max_r)`` int32 array of document ids (−1 pad).
Counterpart of ``repro.retrieval.rprecision``, with the greedy
dimension-drop scorer (:func:`make_dim_drop_scorer`).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.core.preprocess import as_tensor
from repro_torch.retrieval.topk import (similarity, topk_score_then_id,
                                        topk_search)


def recall_at_k(got, want) -> float:
    """Mean per-query overlap of retrieved ids with a reference top-k.

    ``want`` (Q, k) defines the reference set; ``got`` may have any column
    count (extra columns are extra chances, −1 pads never match).
    """
    got, want = (x.cpu().numpy() if isinstance(x, torch.Tensor)
                 else np.asarray(x) for x in (got, want))
    k = want.shape[1]
    return float(np.mean([len(set(got[i]) & set(want[i])) / k
                          for i in range(want.shape[0])]))


def hits_from_topk(idx: torch.Tensor, relevant: torch.Tensor) -> torch.Tensor:
    """Relevant docs among the first r(q) retrieved, per query.

    idx: (…, Q, K) retrieved ids with K ≥ max_r; relevant: (Q, max_r),
    −1 pad.
    """
    relevant = as_tensor(relevant, idx.device).long()
    r = torch.sum(relevant >= 0, dim=1)
    pos_valid = torch.arange(idx.shape[-1], device=idx.device)[None, :] \
        < r[:, None]
    is_rel = torch.any(idx.long()[..., :, :, None] == relevant[:, None, :],
                       dim=-1)
    return torch.sum(is_rel & pos_valid, dim=-1)


def r_precision_from_scores(scores: torch.Tensor,
                            relevant) -> torch.Tensor:
    """R-Precision from dense (…, Q, D) scores (small-scale path): a
    (…,) f32 tensor.  The top-``max_r`` is ``lax.top_k``'s order (score
    desc, lowest column first among ties)."""
    relevant = as_tensor(relevant, scores.device).long()
    max_r = relevant.shape[1]
    cols = torch.arange(scores.shape[-1], device=scores.device)
    _, idx = topk_score_then_id(scores, cols, max_r)
    hits = hits_from_topk(idx, relevant)
    r = torch.clamp(torch.sum(relevant >= 0, dim=1), min=1)
    return torch.mean(hits / r, dim=-1)


def r_precision_from_ids(idx: torch.Tensor, relevant) -> float:
    """R-Precision from retrieved ids (Q, K ≥ max_r), e.g. a search result."""
    relevant = as_tensor(relevant, idx.device)
    r = torch.clamp(torch.sum(relevant >= 0, dim=1), min=1)
    return float(torch.mean(hits_from_topk(idx, relevant) / r))


def retrieved_relevant_counts(queries: torch.Tensor, docs: torch.Tensor,
                              relevant, sim: str = "ip",
                              doc_chunk: int = 131072) -> torch.Tensor:
    """Per-query number of relevant docs in the top-r(q) (paper Fig. 7)."""
    relevant = as_tensor(relevant, queries.device)
    _, idx = topk_search(queries, docs, relevant.shape[1], sim=sim,
                         doc_chunk=doc_chunk)
    return hits_from_topk(idx, relevant)


def r_precision(queries: torch.Tensor, docs: torch.Tensor, relevant,
                sim: str = "ip", doc_chunk: int = 131072) -> float:
    """Streaming R-Precision over an arbitrarily large document index."""
    relevant = as_tensor(relevant, queries.device)
    hits = retrieved_relevant_counts(queries, docs, relevant, sim, doc_chunk)
    r = torch.clamp(torch.sum(relevant >= 0, dim=1), min=1)
    return float(torch.mean(hits / r))


# ---------------------------------------------------------------------------
# Greedy-dimension-dropping scorer (paper §4.1) — per-dimension quality
# ---------------------------------------------------------------------------


def make_dim_drop_scorer(relevant, sim: str = "ip", n_queries: int = 256,
                         n_docs: int = 8192, dim_chunk: int = 16,
                         seed: int = 0
                         ) -> Callable[[torch.Tensor, torch.Tensor],
                                       torch.Tensor]:
    """Build the scorer used by :class:`~repro_torch.core.random_projection.
    GreedyDimensionDrop`.

    Returns ``scorer(queries, docs) → (d,)`` where entry i is the
    R-Precision *with dimension i removed*, on a fixed subsample that holds
    each sampled query's relevant documents plus random distractors.  The
    subsample is drawn with numpy ``default_rng(seed)``, as ``repro``
    draws it, so both packages score the same rows.  The rank-1 update
    ``S_i = S − q_i d_iᵀ`` makes the d evaluations one (Q, D) GEMM and d
    rank-1 updates, ``dim_chunk`` of them a batched tensor.
    """
    relevant = np.asarray(relevant.cpu() if isinstance(relevant, torch.Tensor)
                          else relevant)
    if sim not in ("ip", "l2"):
        raise ValueError("greedy dim-drop scorer supports ip|l2")

    def scorer(queries: torch.Tensor, docs: torch.Tensor) -> torch.Tensor:
        rng = np.random.default_rng(seed)
        n_q = min(n_queries, queries.shape[0])
        qi = rng.choice(queries.shape[0], size=n_q, replace=False)
        rel = relevant[qi]                                    # (q, max_r)
        needed = np.unique(rel[rel >= 0])
        n_total = docs.shape[0]
        budget = max(n_docs - needed.size, 0)
        extra = rng.choice(n_total, size=min(budget, n_total), replace=False)
        doc_ids = np.unique(np.concatenate([needed, extra]))
        lookup = np.full((n_total,), -1, np.int64)
        lookup[doc_ids] = np.arange(doc_ids.size)
        rel_local = np.where(rel >= 0, lookup[np.maximum(rel, 0)], -1)

        dev = docs.device
        rel_local = torch.from_numpy(rel_local).to(dev)
        qs = queries[torch.from_numpy(qi).to(queries.device)].float().to(dev)
        ds = docs[torch.from_numpy(doc_ids).to(dev)].float()
        base = similarity(qs, ds, sim)

        out = []
        for s in range(0, queries.shape[-1], dim_chunk):
            qd, dd = qs[:, s: s + dim_chunk].T, ds[:, s: s + dim_chunk].T
            if sim == "ip":
                dropped = base - qd[:, :, None] * dd[:, None, :]
            else:
                # base is the negative squared distance: add back dim i
                dropped = base + torch.square(qd[:, :, None] - dd[:, None, :])
            out.append(r_precision_from_scores(dropped, rel_local))
        return torch.cat(out)

    return scorer
