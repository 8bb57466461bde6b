"""Plain PyTorch versions of int8 index scoring.

``int8_scores_ref`` is ``repro``'s jnp numerics (decode to f32, GEMM);
``int8_ip_ref`` is the function the CUDA kernel computes, bf16 × u8 with
f32 sums — each product is exact in f32, so only summation order differs.
"""

from __future__ import annotations

import torch


def decode(docs_u8: torch.Tensor, scale: torch.Tensor,
           zero: torch.Tensor) -> torch.Tensor:
    return docs_u8.float() * scale + zero


def int8_scores_ref(queries: torch.Tensor, docs_u8: torch.Tensor,
                    scale: torch.Tensor, zero: torch.Tensor,
                    sim: str = "ip") -> torch.Tensor:
    docs = decode(docs_u8, scale, zero)
    if sim == "ip":
        return queries @ docs.T
    if sim == "l2":
        q2 = torch.sum(queries * queries, dim=-1, keepdim=True)
        d2 = torch.sum(docs * docs, dim=-1)
        return -(q2 + d2[None, :] - 2.0 * (queries @ docs.T))
    raise ValueError(sim)


def int8_ip_ref(q_scaled: torch.Tensor, docs_u8: torch.Tensor,
                bias: torch.Tensor | None = None) -> torch.Tensor:
    """(Q, d) bf16 pre-scaled queries × (D, d) uint8 codes (+ bias[:, None])
    → (Q, D) f32; the bias is one f32 add of the finished sum."""
    out = q_scaled.float() @ docs_u8.float().T
    if bias is not None:
        out += bias[:, None]
    return out
