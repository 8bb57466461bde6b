"""Plain PyTorch versions of the exact top-k.

``topk_blocks_ref`` runs the Pallas tile kernel's own algorithm on every
block of ``block_d`` columns at once: k rounds of max, the lowest column
holding it, then that column set to −inf; columns past D are −inf pads.
``topk_merge_ref`` is stage 2: the row's top k of those candidates by
(score desc, id asc).  ``topk_ref`` is exact top-k over the full row with
ties to the lowest column — ``lax.top_k``'s order.  The order itself,
``topk_score_then_id`` and ``masked_topk_by_id``, is defined here, below
the kernels that reproduce it (``retrieval.topk`` re-exports both).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.utils import cdiv

NEG_INF = float("-inf")


def topk_score_then_id(s: torch.Tensor, ids: torch.Tensor, k: int
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k by (score desc, doc id asc) — a strict total order.

    A stable sort by id, then a stable sort by −score: equal scores keep
    their id order.  (``repro`` does this with one ``lexsort``.)
    """
    ids = ids.expand_as(s)
    by_id = torch.sort(ids, dim=-1, stable=True).indices
    by_score = torch.sort(-torch.gather(s, -1, by_id), dim=-1,
                          stable=True).indices[..., :k]
    order = torch.gather(by_id, -1, by_score)
    return torch.gather(s, -1, order), torch.gather(ids, -1, order)


def masked_topk_by_id(s: torch.Tensor, ids: torch.Tensor, k: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-``k`` by (score desc, id asc), normalising unreachable slots.

    Non-finite scores come back with id ``-1``; fewer than ``k`` candidate
    columns pad the output out to ``k`` with ``(-inf, -1)``.
    """
    kk = min(k, s.shape[1])
    vals, out = topk_score_then_id(s, ids, kk)
    out = torch.where(torch.isfinite(vals), out, -1)
    if kk < k:
        vals = F.pad(vals, (0, k - kk), value=NEG_INF)
        out = F.pad(out, (0, k - kk), value=-1)
    return vals, out


def topk_blocks_ref(scores: torch.Tensor, k: int, block_d: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(Q, D) → per-block top-k values/global indices (Q, n_blocks·k)."""
    n_q, n_d = scores.shape
    k = min(k, n_d)
    n_blocks = cdiv(n_d, block_d)
    s = F.pad(scores.float(), (0, n_blocks * block_d - n_d), value=NEG_INF)
    s = s.reshape(n_q, n_blocks, block_d).clone()
    iota = torch.arange(block_d, device=s.device)
    base = torch.arange(n_blocks, device=s.device)[None, :] * block_d
    vals = torch.empty((n_q, n_blocks, k), device=s.device)
    idx = torch.empty((n_q, n_blocks, k), dtype=torch.int32, device=s.device)
    for i in range(k):
        m = torch.amax(s, dim=-1)
        am = torch.amin(torch.where(s == m[..., None], iota, block_d), dim=-1)
        vals[..., i] = m
        idx[..., i] = am + base
        s.scatter_(-1, am[..., None], NEG_INF)
    return vals.reshape(n_q, -1), idx.reshape(n_q, -1)


def topk_merge_ref(vals: torch.Tensor, idx: torch.Tensor, k: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Stage 2 over (Q, n_blocks·k) candidates → (Q, k) values and int64
    ids by (score desc, id asc), by ``topk_score_then_id``'s two stable
    sorts: ``topk_merge``'s CPU path."""
    vals, idx = topk_score_then_id(vals, idx, k)
    return vals, idx.long()


def topk_ref(scores: torch.Tensor, k: int
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over the full row; equal scores go to the lowest column."""
    k = min(k, scores.shape[-1])
    order = torch.sort(-scores, dim=-1, stable=True).indices[..., :k]
    return torch.gather(scores, -1, order), order
