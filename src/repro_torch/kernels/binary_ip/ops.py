"""Public op: score float/encoded queries against a bit-packed 1-bit index.

With b ∈ {0,1}, s = 2b − 1 ∈ {±1} and value v = b − α = s/2 + c,
c = 0.5 − α:

    IP(v_q, v_d) = 0.25·(s_q·s_d) + c/2·(Σs_q + Σs_d) + d·c²

For α = 0.5 the correction terms vanish.  d here is the packed width
(32 per word, encoder padding included), as in ``repro.kernels.binary_ip``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.quantization import unpack_bits
from repro_torch.kernels.binary_ip import ref as _ref
from repro_torch.kernels.binary_ip.kernel import binary_ip


def _sign_sums_from_packed(packed: torch.Tensor, d: int) -> torch.Tensor:
    """Σ signs per row from packed words: 2·popcount − d."""
    shifts = torch.arange(32, dtype=torch.int32, device=packed.device)
    bits = (packed[..., None] >> shifts) & 1
    pop = torch.sum(bits, dim=(-1, -2), dtype=torch.int32)
    return 2 * pop - d


def _query_signs(queries: torch.Tensor, n_words: int, d: int
                 ) -> torch.Tensor:
    """Float queries (only their signs matter) or packed int32 words →
    (Q, 32·n_words) ±1 int8, padded with −1 as the encoder pads."""
    if queries.dtype == torch.int32:
        return unpack_bits(queries, d)
    q_signs = torch.where(queries >= 0, 1, -1).to(torch.int8)
    if q_signs.shape[-1] != d:
        raise ValueError("query dim mismatch")
    pad = n_words * 32 - d
    if pad:
        q_signs = F.pad(q_signs, (0, pad), value=-1)
    return q_signs


def _offset_terms(scores: torch.Tensor, q_signs: torch.Tensor,
                  sum_d: torch.Tensor, d_packed: int,
                  offset: float) -> torch.Tensor:
    """Add the α ≠ 0.5 corrections; ``sum_d`` broadcasts against (Q, ·)."""
    c = 0.5 - offset
    sum_q = torch.sum(q_signs, dim=-1, dtype=torch.int32)
    return scores + (c / 2.0) * (sum_q[:, None] + sum_d) + d_packed * c * c


def binary_ip_scores(queries: torch.Tensor, docs_packed: torch.Tensor,
                     d: int, offset: float = 0.5,
                     use_kernel: bool = False) -> torch.Tensor:
    """(Q, D) scores of offset-encoded 1-bit vectors.

    ``queries`` are floats (only their signs matter) or packed int32 words.
    Both backends give the same scores bit for bit (integer arithmetic).
    """
    q_signs = _query_signs(queries, docs_packed.shape[-1], d)
    d_packed = docs_packed.shape[-1] * 32   # includes encoder padding
    score = binary_ip if use_kernel else _ref.binary_ip_ref
    scores = score(q_signs, docs_packed)      # f32 0.25·dot
    if offset == 0.5:
        return scores
    sum_d = _sign_sums_from_packed(docs_packed, d_packed)[None, :]
    return _offset_terms(scores, q_signs, sum_d, d_packed, offset)


def binary_ip_scores_gathered(queries: torch.Tensor, gathered: torch.Tensor,
                              d: int, offset: float = 0.5) -> torch.Tensor:
    """(Q, d) queries × (Q, C, d/32) packed words → (Q, C), each query
    against its own candidate rows (the IVF streaming path).  Integer
    arithmetic: the same bits as :func:`binary_ip_scores` either way."""
    q_signs = _query_signs(queries, gathered.shape[-1], d)
    d_packed = gathered.shape[-1] * 32
    scores = _ref.sign_dot_gathered_ref(q_signs, gathered).float().mul_(0.25)
    if offset == 0.5:
        return scores
    return _offset_terms(scores, q_signs,
                         _sign_sums_from_packed(gathered, d_packed),
                         d_packed, offset)
