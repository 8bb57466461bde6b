"""Exact maximum-similarity search with streaming (chunked) top-k.

Counterpart of ``repro.retrieval.topk``.  Every ranking here is the strict
``(score desc, id asc)`` order.  ``torch.topk`` and an unstable
``torch.sort`` promise nothing among ties, so ranking here is done by two
stable sorts (by id, then by −score), and per-chunk top-k goes through the
two-stage top-k (``topk_blocks``, then ``topk_merge``, which merges the
blocks' sorted lists without a sort), whose ties go to the lowest column
— the order ``lax.top_k`` gives in ``repro``.  Every exact search of the
port runs the one loop :func:`_exact_topk`."""

from __future__ import annotations

import torch

from repro_torch.kernels.topk_blocks.ops import streaming_topk
from repro_torch.kernels.topk_blocks.ref import (  # noqa: F401 (re-exported)
    NEG_INF, masked_topk_by_id, topk_score_then_id)
from repro_torch.utils import chunked, use_kernel

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


def _exact_topk(score, queries: tuple[torch.Tensor, ...],
                docs: torch.Tensor, k: int, *, kernel: bool,
                query_chunk: int, doc_chunk: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Each query row's top ``k`` of ``docs``' rows by (score desc, id
    asc): (Q, k) f32 scores and int64 ids.

    ``score(*q, block)`` scores a row chunk of ``queries`` (tensors that
    share their rows) against a block of ``docs``; whole tensors where
    one chunk or block covers them.  One block's ``streaming_topk`` is the
    result as it is; several (or none) fold in order from ``(−inf, 0)``.
    """
    n_q, n_rows = queries[0].shape[0], docs.shape[0]
    one_block = 0 < n_rows <= doc_chunk
    blocks = [(0, n_rows)] if one_block else list(chunked(n_rows, doc_chunk))
    out_v, out_i = [], []
    for a, b in chunked(n_q, query_chunk):
        q = queries if b - a == n_q else tuple(t[a:b] for t in queries)
        if not one_block:
            vals = torch.full((b - a, k), NEG_INF, device=docs.device)
            idx = torch.zeros((b - a, k), dtype=torch.long,
                              device=docs.device)
        for lo, hi in blocks:
            v, i = streaming_topk(score(*q, docs if one_block else
                                        docs[lo:hi]), k, use_kernel=kernel)
            vals, idx = ((v, i) if one_block
                         else merge_topk(vals, idx, v, i + lo, k))
        out_v.append(vals)
        out_i.append(idx)
    return torch.cat(out_v), torch.cat(out_i)


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
    k = resolve_k(k, docs.shape[0])
    return _exact_topk(lambda q, d: similarity(q, d, sim), (queries,), docs,
                       k, kernel=use_kernel(backend, docs.device),
                       query_chunk=query_chunk, doc_chunk=doc_chunk)
