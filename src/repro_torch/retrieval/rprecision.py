"""R-Precision evaluation (paper §3.1, following Petroni et al. 2021).

For query q with r(q) relevant documents, R-Precision is
``|relevant ∩ top-r(q) retrieved| / r(q)``, averaged over queries.
Relevance is a padded ``(Q, max_r)`` int32 array of document ids (−1 pad).
Counterpart of ``repro.retrieval.rprecision`` (the greedy dimension-drop
scorer waits for the off-path transforms of a later slice).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.preprocess import as_tensor
from repro_torch.retrieval.topk import topk_search


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

    idx: (Q, K) retrieved ids with K ≥ max_r; relevant: (Q, max_r), −1 pad.
    """
    relevant = as_tensor(relevant, idx.device).long()
    r = torch.sum(relevant >= 0, dim=1)
    pos_valid = torch.arange(idx.shape[1], device=idx.device)[None, :] \
        < r[:, None]
    is_rel = torch.any(idx.long()[:, :, None] == relevant[:, None, :], dim=-1)
    return torch.sum(is_rel & pos_valid, dim=1)


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
