"""Plain PyTorch version of the fused IVF top-k.

The function ``csrc/ivf_fused.cu`` computes, as a loop over probe slots:
gather each query's probed list, score it in f32 per backend, add the
slot's base, mask pad rows, and fold the block into the running top-k
with :func:`~repro_torch.kernels.topk_blocks.ref.masked_topk_by_id`.
(score desc, id asc) is a strict total order, so folding list by list
gives the kernel's result exactly.  int8 scores are ``qe.float() @
codes.float().T`` in f32 — a bf16 matmul would round its output.

:func:`list_major_topk_ref` mirrors the card's stages instead — invert
the probe table, score each list once for the (query, slot) pairs that
probe it and keep each pair's top-min(k, L), merge each query's
candidates — for the tests, which hold it equal to the slot-by-slot fold;
no search path calls it.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.binary_ip.ref import sign_dot_gathered_ref
from repro_torch.kernels.topk_blocks.ref import NEG_INF, masked_topk_by_id

BACKENDS = ("float", "fp16", "int8", "onebit")


def score_lists(qe: torch.Tensor, blocks: torch.Tensor,
                backend: str) -> torch.Tensor:
    """(Q, dq) encoded queries × (Q, L, w) list rows → (Q, L) f32 scores."""
    if backend in ("float", "fp16", "int8"):
        return torch.matmul(blocks.float(), qe.float()[:, :, None])[..., 0]
    if backend == "onebit":
        return 0.25 * sign_dot_gathered_ref(qe, blocks).float()
    raise ValueError(f"unknown fused backend {backend!r}")


def fused_ivf_topk_ref(probes: torch.Tensor, qe: torch.Tensor,
                       list_storage: torch.Tensor, list_ids: torch.Tensor,
                       base: torch.Tensor, k: int, backend: str
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Same contract as the kernel wrapper: (Q, k) values and int32 ids."""
    n_q = probes.shape[0]
    vals = torch.full((n_q, k), NEG_INF, device=qe.device)
    ids = torch.full((n_q, k), -1, dtype=torch.int32, device=qe.device)
    for j in range(probes.shape[1]):
        pj = probes[:, j].long()
        ids_j = list_ids[pj]                                  # (Q, L)
        s = score_lists(qe, list_storage[pj], backend) + base[:, j:j + 1]
        s = torch.where(ids_j >= 0, s, NEG_INF)
        vals, ids = masked_topk_by_id(
            torch.cat([vals, s], dim=1),
            torch.cat([ids, torch.where(ids_j >= 0, ids_j, -1)], dim=1), k)
    return vals, ids


def list_major_topk_ref(probes: torch.Tensor, qe: torch.Tensor,
                        list_storage: torch.Tensor, list_ids: torch.Tensor,
                        base: torch.Tensor, k: int, backend: str
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's three stages in plain PyTorch; the contract of
    :func:`fused_ivf_topk_ref`.  Probes outside [0, nlist) are skipped."""
    n_q, nprobe = probes.shape
    nlist, max_len, _ = list_storage.shape
    m = min(k, max_len)
    # (a) invert: each list's (query·nprobe + slot) pairs
    flat = probes.reshape(-1).long()
    pairs = torch.nonzero((flat >= 0) & (flat < nlist))[:, 0]
    pairs = pairs[torch.argsort(flat[pairs], stable=True)]
    counts = torch.bincount(flat[pairs], minlength=nlist).tolist()
    # (b) each probed list scored once for all its pairs: top-m per pair
    cand_v = torch.full((n_q * nprobe, m), NEG_INF, device=qe.device)
    cand_i = torch.full((n_q * nprobe, m), -1, dtype=torch.int32,
                        device=qe.device)
    flat_base = base.reshape(-1)
    start = 0
    for lid, c in enumerate(counts):
        if not c:
            continue
        pr = pairs[start: start + c]
        start += c
        rows = list_storage[lid][None].expand(c, -1, -1)
        s = score_lists(qe[pr // nprobe], rows, backend) \
            + flat_base[pr][:, None]
        ids_l = list_ids[lid][None].expand(c, -1)
        s = torch.where(ids_l >= 0, s, NEG_INF)
        cand_v[pr], cand_i[pr] = masked_topk_by_id(
            s, torch.where(ids_l >= 0, ids_l, -1), m)
    # (c) merge each query's nprobe·m candidates
    return masked_topk_by_id(cand_v.view(n_q, nprobe * m),
                             cand_i.view(n_q, nprobe * m), k)
