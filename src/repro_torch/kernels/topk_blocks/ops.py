"""Public op: exact two-stage top-k over a score matrix.

Stage 1 (:func:`~repro_torch.kernels.topk_blocks.kernel.topk_blocks`) keeps
each block's top k; stage 2
(:func:`~repro_torch.kernels.topk_blocks.kernel.topk_merge`) merges those
sorted lists into the row's top k by (score desc, id asc).  Every global
top-k element is a top-k element of its own block, so the result is
exact, in ``lax.top_k``'s order on the full row.  Counterpart of
``repro.kernels.topk_blocks.ops``.
"""

from __future__ import annotations

import torch

from repro_torch import tracing
from repro_torch.kernels.topk_blocks import ref as _ref
from repro_torch.kernels.topk_blocks.kernel import (next_pow2,
                                                    topk_blocks,
                                                    topk_merge)

MIN_BLOCK_D = 1024
#: the largest block the kernel holds in shared memory
MAX_SMEM_BLOCK_D = 32768
#: a block holds about this many times k, so stage 2 sees ~1/32 of a row
BLOCK_PER_K = 32


def default_block_d(k: int) -> int:
    """``max(1024, next_pow2(k), min(32768, next_pow2(32·k)))``: a block
    always holds k, and at deep k stage 2 sees about 3% of a row."""
    return max(MIN_BLOCK_D, next_pow2(k),
               min(MAX_SMEM_BLOCK_D, next_pow2(BLOCK_PER_K * k)))


def streaming_topk(scores: torch.Tensor, k: int, use_kernel: bool = False,
                   block_d: int | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(Q, D) → top-k (values, global int64 indices), descending."""
    if not use_kernel:
        vals, idx = _ref.topk_ref(scores, k)
        return vals, idx.long()
    vals, idx = topk_blocks(scores, k, block_d or default_block_d(k))
    tracing.count("topk.merge_candidates", vals.numel())
    with tracing.span("search.topk.merge", scores.device):
        return topk_merge(vals, idx, min(k, scores.shape[-1]))
