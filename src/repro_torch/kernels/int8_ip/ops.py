"""Public op: score float queries against an int8-quantized index.

IP decomposition: ``q·x = (q⊙scale)·u + q·zero``.  The kernel computes the
first term from bf16(q⊙scale) and the uint8 codes and adds the rank-1
``q·zero`` term as its per-query bias, in the same pass; this wrapper adds,
for l2, the decoded document norms.  Counterpart of
``repro.kernels.int8_ip.ops``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.int8_ip import ref as _ref
from repro_torch.kernels.int8_ip.kernel import int8_ip


def _doc_sq_norms(docs_u8: torch.Tensor, scale: torch.Tensor,
                  zero: torch.Tensor, chunk: int = 262144) -> torch.Tensor:
    outs = []
    for s in range(0, docs_u8.shape[0], chunk):
        d = _ref.decode(docs_u8[s: s + chunk], scale, zero)
        outs.append(torch.sum(d * d, dim=-1))
    return torch.cat(outs)


def int8_scores(queries: torch.Tensor, docs_u8: torch.Tensor,
                scale: torch.Tensor, zero: torch.Tensor, sim: str = "ip",
                use_kernel: bool = False) -> torch.Tensor:
    """(Q, D) similarity between float queries and uint8 index codes.

    ``use_kernel`` selects ``repro``'s pallas numerics (bf16 query scaling)
    over its jnp numerics (decode to f32).
    """
    queries = queries.float()
    if not use_kernel:
        return _ref.int8_scores_ref(queries, docs_u8, scale, zero, sim)
    q_scaled = (queries * scale).to(torch.bfloat16)
    ip = int8_ip(q_scaled, docs_u8, bias=queries @ zero)
    if sim == "ip":
        return ip
    if sim == "l2":
        q2 = torch.sum(queries * queries, dim=-1, keepdim=True)
        d2 = _doc_sq_norms(docs_u8, scale, zero)
        return -(q2 + d2[None, :] - 2.0 * ip)
    raise ValueError(sim)


def int8_scores_gathered(queries: torch.Tensor, codes: torch.Tensor,
                         scale: torch.Tensor, zero: torch.Tensor,
                         sim: str = "ip", use_kernel: bool = False
                         ) -> torch.Tensor:
    """(Q, d) float queries × (Q, C, d) uint8 codes → (Q, C), each query
    against its own candidate rows, in either numerics of
    :func:`int8_scores` (computed in plain torch: the IVF streaming path)."""
    queries = queries.float()
    if use_kernel:
        q_scaled = (queries * scale).to(torch.bfloat16).float()
        ip = torch.matmul(codes.float(), q_scaled[:, :, None])[..., 0]
        ip += (queries @ zero)[:, None]
    else:
        ip = torch.matmul(_ref.decode(codes, scale, zero),
                          queries[:, :, None])[..., 0]
    if sim == "ip":
        return ip
    if sim == "l2":
        q2 = torch.sum(queries * queries, dim=-1, keepdim=True)
        docs = _ref.decode(codes, scale, zero)
        return -(q2 + torch.sum(docs * docs, dim=-1) - 2.0 * ip)
    raise ValueError(sim)
