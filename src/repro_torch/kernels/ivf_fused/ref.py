"""Plain PyTorch version of the fused IVF top-k.

The function ``csrc/ivf_fused.cu`` computes, as a loop over probe slots:
gather each query's probed list, score it in f32 per backend, add the
slot's base, mask pad rows, and fold the block into the running top-k with
:func:`~repro_torch.retrieval.topk.masked_topk_by_id`.  (score desc, id
asc) is a strict total order, so folding list by list gives the kernel's
result exactly.  int8 scores are ``qe.float() @ codes.float().T`` in f32 —
a bf16 matmul would round its output.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.binary_ip.ref import sign_dot_gathered_ref
from repro_torch.retrieval.topk import NEG_INF, masked_topk_by_id

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
