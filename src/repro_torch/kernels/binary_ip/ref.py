"""Plain PyTorch version of 1-bit index scoring (paper §4.4 semantics).

``binary_ip_ref`` is the function the CUDA kernel computes: 0.25 × the ±1
sign dot over all packed positions, pad bits included, in f32.
``sign_dot_ref`` is that dot; it multiplies in f32, where every partial sum
of ±1 terms is an exact integer (|dot| ≤ d < 2²⁴), since PyTorch has no
integer matmul on the card.  0.25·dot is exact in f32 as well.
"""

from __future__ import annotations

import torch

from repro_torch.core.quantization import unpack_bits


def sign_dot_ref(q_signs: torch.Tensor, docs_packed: torch.Tensor
                 ) -> torch.Tensor:
    """(Q, d) ±1 int8 × (D, d/32) packed words → (Q, D) int32 sign dots."""
    signs = unpack_bits(docs_packed, q_signs.shape[-1])
    return (q_signs.float() @ signs.float().T).to(torch.int32)


def binary_ip_ref(q_signs: torch.Tensor, docs_packed: torch.Tensor
                  ) -> torch.Tensor:
    """(Q, d) ±1 int8 × (D, d/32) packed words → (Q, D) f32 0.25·dot."""
    return sign_dot_ref(q_signs, docs_packed).float().mul_(0.25)


def sign_dot_gathered_ref(q_signs: torch.Tensor, words: torch.Tensor
                          ) -> torch.Tensor:
    """(Q, d) ±1 int8 × (Q, C, d/32) words → (Q, C) int32 sign dots, each
    query against its own candidate rows."""
    signs = unpack_bits(words, q_signs.shape[-1]).float()
    return torch.matmul(signs, q_signs.float()[:, :, None])[..., 0] \
        .to(torch.int32)
