"""Exact maximum-similarity search with streaming (chunked) top-k.

Counterpart of ``repro.retrieval.topk``.  Every ranking here is the strict
``(score desc, id asc)`` order.  ``torch.topk`` and an unstable
``torch.sort`` promise nothing among ties, so ranking here is done by two
stable sorts (by id, then by −score), and per-chunk top-k goes through the
two-stage top-k (``topk_blocks``, then ``topk_merge``, which merges the
blocks' sorted lists without a sort), whose ties go to the lowest column
— the order ``lax.top_k`` gives in ``repro``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.utils import use_kernel

NEG_INF = float("-inf")
INT32_MAX = 2**31 - 1


def resolve_k(k: int, n_docs: int) -> int:
    """The one ``k`` contract: ``k`` ≥ 1, clamped to ``n_docs``."""
    if k < 1:
        raise ValueError(f"k must be ≥ 1, got {k}")
    return min(int(k), int(n_docs))


def resolve_nprobe(nprobe, nlist: int, default=None) -> int:
    """The one ``nprobe`` contract, mirroring :func:`resolve_k`."""
    if nprobe is None:
        nprobe = default
    if nprobe is None or nprobe < 1:
        raise ValueError(f"nprobe must be ≥ 1, got {nprobe}")
    return min(int(nprobe), int(nlist))


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


def merge_topk_block(run_v: torch.Tensor, run_i: torch.Tensor,
                     cand_v: torch.Tensor, cand_i: torch.Tensor, k: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge a scored block into a (Q, k) running top-k — no sort.

    ``k`` rounds of max score → min id among the hits → retire the winner;
    the same (score desc, id asc) order as :func:`masked_topk_by_id`, with
    pad entries (−inf, −1).  Requires distinct (score, id) pairs among the
    reachable candidates.
    """
    cv = torch.cat([run_v, cand_v], dim=1)
    ci = torch.cat([run_i, cand_i], dim=1)
    kw = run_v.shape[1]
    new_v = torch.full_like(run_v, NEG_INF)
    new_i = torch.full_like(run_i, -1)
    for t in range(min(k, kw)):
        m = torch.amax(cv, dim=1)
        hit = cv == m[:, None]
        sel = torch.amin(torch.where(hit, ci, INT32_MAX), dim=1)
        new_v[:, t] = m
        new_i[:, t] = sel
        cv = torch.where(hit & (ci == sel[:, None]), NEG_INF, cv)
    # unreachable rounds picked a (−inf, ·) entry: normalise the id to −1
    new_i = torch.where(new_v == NEG_INF, -1, new_i)
    return new_v, new_i


def streaming_masked_topk(s: torch.Tensor, ids: torch.Tensor, k: int,
                          block: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Blockwise-streamed :func:`masked_topk_by_id`, identical for any
    ``block`` because the order is strict."""
    if block < 1:
        raise ValueError(f"block must be ≥ 1, got {block}")
    run_v, run_i = masked_topk_by_id(s[:, :block], ids[:, :block], k)
    for ds in range(block, s.shape[1], block):
        cv = torch.cat([run_v, s[:, ds: ds + block]], dim=1)
        ci = torch.cat([run_i, ids[:, ds: ds + block]], dim=1)
        run_v, run_i = masked_topk_by_id(cv, ci, k)
    return run_v, run_i


def similarity(queries: torch.Tensor, docs: torch.Tensor,
               sim: str) -> torch.Tensor:
    """(Q, d) × (D, d) → (Q, D) similarity. sim ∈ {"ip", "l2", "cos"}.

    "l2" is the *negative squared* L2 distance, so search is argmax for
    every metric.
    """
    if sim == "ip":
        return queries @ docs.T
    if sim == "cos":
        qn = queries / (torch.linalg.vector_norm(queries, dim=-1,
                                                 keepdim=True) + 1e-12)
        dn = docs / (torch.linalg.vector_norm(docs, dim=-1,
                                              keepdim=True) + 1e-12)
        return qn @ dn.T
    if sim == "l2":
        q2 = torch.sum(queries * queries, dim=-1, keepdim=True)
        d2 = torch.sum(docs * docs, dim=-1)
        return -(q2 + d2[None, :] - 2.0 * (queries @ docs.T))
    raise ValueError(f"unknown similarity {sim!r}")


def similarity_gathered(queries: torch.Tensor, docs: torch.Tensor,
                        sim: str) -> torch.Tensor:
    """(Q, d) × (Q, C, d) → (Q, C): each query against its own candidate
    rows (IVF's gathered lists); the batched form of :func:`similarity`."""
    if sim == "cos":
        queries = queries / (torch.linalg.vector_norm(
            queries, dim=-1, keepdim=True) + 1e-12)
        docs = docs / (torch.linalg.vector_norm(docs, dim=-1,
                                                keepdim=True) + 1e-12)
    ip = torch.matmul(docs, queries[:, :, None])[..., 0]
    if sim in ("ip", "cos"):
        return ip
    if sim == "l2":
        q2 = torch.sum(queries * queries, dim=-1, keepdim=True)
        d2 = torch.sum(docs * docs, dim=-1)
        return -(q2 + d2 - 2.0 * ip)
    raise ValueError(f"unknown similarity {sim!r}")


def topk_in_order(vals: torch.Tensor, idx: torch.Tensor, k: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest ``vals`` per row with their ``idx``; equal values
    keep their column order, as ``lax.top_k`` does."""
    pos = torch.sort(-vals, dim=-1, stable=True).indices[..., :k]
    return torch.gather(vals, -1, pos), torch.gather(idx, -1, pos)


def merge_topk(vals_a, idx_a, vals_b, idx_b, k):
    """Merge two top-k candidate sets; equal scores keep earlier entries
    first (``a`` before ``b``), as ``lax.top_k`` does."""
    return topk_in_order(torch.cat([vals_a, vals_b], dim=-1),
                         torch.cat([idx_a, idx_b], dim=-1), k)


def topk_search(queries: torch.Tensor, docs: torch.Tensor, k: int,
                sim: str = "ip", doc_chunk: int = 131072,
                query_chunk: int = 4096, backend: str = "auto"
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over the document axis, streamed in chunks.

    Returns (scores (Q, k), indices (Q, k)) in (score desc, id asc) order.
    Each chunk's top-k runs through ``topk_blocks`` and ``topk_merge``
    (the Hopper kernels where ``backend`` resolves to kernel numerics on a
    CUDA tensor).
    """
    from repro_torch.kernels.topk_blocks.ops import streaming_topk

    n_docs = docs.shape[0]
    k = resolve_k(k, n_docs)
    kernel = use_kernel(backend, docs.device)
    out_vals, out_idx = [], []
    for qs in range(0, queries.shape[0], query_chunk):
        q = queries[qs: qs + query_chunk]
        vals = torch.full((q.shape[0], k), NEG_INF, device=q.device)
        idx = torch.zeros((q.shape[0], k), dtype=torch.long, device=q.device)
        for ds in range(0, n_docs, doc_chunk):
            scores = similarity(q, docs[ds: ds + doc_chunk], sim)
            cv, ci = streaming_topk(scores, k, use_kernel=kernel)
            if cv.shape[-1] < k:  # chunk smaller than k: pad
                pad = k - cv.shape[-1]
                cv = F.pad(cv, (0, pad), value=NEG_INF)
                ci = F.pad(ci, (0, pad))
            vals, idx = merge_topk(vals, idx, cv, ci.long() + ds, k)
        out_vals.append(vals)
        out_idx.append(idx)
    return torch.cat(out_vals, dim=0), torch.cat(out_idx, dim=0)
