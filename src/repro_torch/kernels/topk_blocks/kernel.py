"""Wrappers of the two stages of the exact top-k (``csrc/topk_blocks.cu``).

``topk_blocks`` replaces ``repro.kernels.topk_blocks.kernel.
topk_blocks_pallas``: (Q, D) f32 scores → for each block of ``block_d``
columns its top k as (Q, n_blocks·k) values and global int32 column
indices, equal values to the lowest column.  ``topk_merge`` replaces the
``lax.top_k`` of ``repro.kernels.topk_blocks.ops`` (stage 2): those
candidates → the row's top k by (score desc, id asc), int64 ids.  CUDA
tensors launch the kernel (or raise); CPU tensors run the plain version
(:mod:`~repro_torch.kernels.topk_blocks.ref`), and meta tensors (an
abstract pass, which has no values) one ``torch.topk``.

On the card each stage counts the inputs that took its slow tie path in
a device counter of :mod:`repro_torch.tracing`: ``topk_blocks.tie_tiles``
((row, block) tiles that took the radix select or the warp kernel's
rounds, out of ``topk_blocks.tiles``, a host count) and
``topk_merge.tie_rows`` (rows whose runs overflowed the buffer).  Stage
1's ring path (32 < k ≤ 128, ``block_d`` ≤ 4,096) also adds to the
device counter ``topk_blocks.bound_survivors`` the elements at or above
its bound in each tile it did not send down the tie path: over
``topk_blocks.tiles`` − ``topk_blocks.tie_tiles`` of such calls, how
many entries it chose the k from.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import tracing
from repro_torch.kernels import _build
from repro_torch.kernels.topk_blocks.ref import (topk_blocks_ref,
                                                 topk_merge_ref)
from repro_torch.utils import cdiv

#: survivors sorted in shared memory; a longer sort runs in a global scratch
MAX_SMEM_SORT = 8192


def next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


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
        ties = tracing.device_counter("topk_blocks.tie_tiles", s.device)
        survivors = tracing.device_counter("topk_blocks.bound_survivors",
                                           s.device)
        with torch.cuda.device(s.device):
            _build.check(_build.library().topk_blocks_launch(
                s.data_ptr(), vals.data_ptr(), idx.data_ptr(),
                scratch.data_ptr() if scratch is not None else None,
                ties.data_ptr(), survivors.data_ptr(), n_q, n_d, k, block_d,
                n_blocks, p2, _build.stream_handle(s)), "topk_blocks")
        tracing.count("topk_blocks.launches")
        tracing.count("topk_blocks.tiles", n_q * n_blocks)
    return vals, idx


def _merge_buffer(k: int) -> tuple[int, bool]:
    """(entries, in shared memory?) of ``topk_merge``'s survivors' buffer:
    the power of two ≥ 4k while that is at most ``MAX_SMEM_SORT``, else
    the power of two ≥ 2k in a global scratch.  More survivors than it
    holds (heavy ties) take the kernel's exact path."""
    cap = next_pow2(4 * k)
    if cap <= MAX_SMEM_SORT:
        return cap, True
    return next_pow2(2 * k), False


def topk_merge(vals: torch.Tensor, idx: torch.Tensor, k: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Stage 2: ``topk_blocks``' (Q, n_blocks·k) candidates → the row's top
    k, (Q, k) f32 values (their bits as given) and int64 ids, by (score
    desc, id asc).  The kernel relies on stage 1's order: each block's k
    entries by (value desc, column asc), the blocks in column order."""
    if (vals.dtype != torch.float32 or idx.dtype != torch.int32
            or vals.ndim != 2 or idx.shape != vals.shape):
        raise TypeError(f"topk_merge takes (Q, n_blocks·k) float32 values "
                        f"and int32 ids, got {vals.dtype} "
                        f"{tuple(vals.shape)} and {idx.dtype} "
                        f"{tuple(idx.shape)}")
    n_q, n = vals.shape
    if not ((k == 0 and n == 0) or (k >= 1 and n >= k and n % k == 0)):
        raise ValueError(f"topk_merge needs lists of k: {n} candidates a "
                         f"row, k={k}")
    if vals.device != idx.device:
        raise ValueError(f"topk_merge: values on {vals.device}, ids on "
                         f"{idx.device}")
    if not (vals.is_contiguous() and idx.is_contiguous()):
        raise ValueError("topk_merge takes contiguous candidates")
    if vals.device.type == "meta":
        # an abstract pass's stand-in: the outputs' shapes and dtypes from
        # one torch.topk, which reads the candidates once, as the kernel
        # does at most
        return torch.topk(vals, k)
    if vals.device.type == "cpu":
        return topk_merge_ref(vals, idx, k)
    if vals.device.type != "cuda":
        raise ValueError(f"topk_merge: unsupported device {vals.device}")
    out_v = torch.empty((n_q, k), dtype=torch.float32, device=vals.device)
    out_i = torch.empty((n_q, k), dtype=torch.int64, device=vals.device)
    if n_q and k:
        cap, in_smem = _merge_buffer(k)
        scratch = (None if in_smem else
                   torch.empty(n_q * cap, dtype=torch.int64,
                               device=vals.device))
        ties = tracing.device_counter("topk_merge.tie_rows", vals.device)
        with torch.cuda.device(vals.device):
            _build.check(_build.library().topk_merge_launch(
                vals.data_ptr(), idx.data_ptr(), out_v.data_ptr(),
                out_i.data_ptr(),
                scratch.data_ptr() if scratch is not None else None,
                ties.data_ptr(), n_q, n // k, k, cap,
                _build.stream_handle(vals)), "topk_merge")
        tracing.count("topk_merge.launches")
    return out_v, out_i
