"""Wrapper of the per-block top-k kernel (``csrc/topk_blocks.cu``).

Replaces ``repro.kernels.topk_blocks.kernel.topk_blocks_pallas``: (Q, D)
f32 scores → for each block of ``block_d`` columns its top k as
(Q, n_blocks·k) values and global int32 column indices, equal values to
the lowest column.  CUDA tensors launch the kernel (or raise); CPU tensors
run :func:`~repro_torch.kernels.topk_blocks.ref.topk_blocks_ref`, and meta
tensors (an abstract pass, which has no values) one ``torch.topk``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import tracing
from repro_torch.kernels import _build
from repro_torch.kernels.topk_blocks.ref import topk_blocks_ref
from repro_torch.utils import cdiv

#: survivors sorted in shared memory; a longer sort runs in a global scratch
MAX_SMEM_SORT = 8192


def _topk_blocks_meta(scores: torch.Tensor, k: int, block_d: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """An abstract pass's stand-in: the outputs' shapes and dtypes from one
    ``torch.topk`` over the blocks, which reads the scores once and writes
    the outputs once, as the kernel does (the plain version's k rounds
    would cost an abstract pass k times the ops)."""
    n_q, n_d = scores.shape
    k = min(k, n_d)
    if k > block_d:
        return topk_blocks_ref(scores, k, block_d)
    n_blocks = cdiv(n_d, block_d)
    s = scores
    if n_blocks * block_d != n_d:
        s = F.pad(s, (0, n_blocks * block_d - n_d), value=float("-inf"))
    vals, idx = torch.topk(s.reshape(n_q, n_blocks, block_d), k)
    return vals.reshape(n_q, -1), idx.reshape(n_q, -1).to(torch.int32)


def topk_blocks(scores: torch.Tensor, k: int, block_d: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(Q, D) f32 → per-block top-k values/indices (Q, n_blocks·k)."""
    if scores.dtype != torch.float32 or scores.ndim != 2:
        raise TypeError(f"topk_blocks takes a 2-D float32 matrix, got "
                        f"{scores.dtype} {tuple(scores.shape)}")
    if k < 1 or block_d < 1:
        raise ValueError(f"topk_blocks needs k ≥ 1 and block_d ≥ 1, got "
                         f"k={k}, block_d={block_d}")
    if scores.device.type == "meta":
        return _topk_blocks_meta(scores, k, block_d)
    if scores.device.type == "cpu":
        return topk_blocks_ref(scores, k, block_d)
    if scores.device.type != "cuda":
        raise ValueError(f"topk_blocks: unsupported device {scores.device}")
    s = scores.contiguous()
    n_q, n_d = s.shape
    k = min(k, n_d)
    n_blocks = cdiv(n_d, block_d)
    p2 = 1 << (min(k, block_d) - 1).bit_length()   # the survivors' sort
    scratch = (torch.empty(n_q * n_blocks * p2, dtype=torch.int64,
                           device=s.device)
               if p2 > MAX_SMEM_SORT and n_q and n_d else None)
    vals = torch.empty((n_q, n_blocks * k), dtype=torch.float32,
                       device=s.device)
    idx = torch.empty((n_q, n_blocks * k), dtype=torch.int32, device=s.device)
    if n_q and n_d:
        with torch.cuda.device(s.device):
            _build.check(_build.library().topk_blocks_launch(
                s.data_ptr(), vals.data_ptr(), idx.data_ptr(),
                scratch.data_ptr() if scratch is not None else None, n_q,
                n_d, k, block_d, n_blocks, p2, _build.stream_handle(s)),
                "topk_blocks")
        tracing.count("topk_blocks.launches")
    return vals, idx
