"""Wrapper of the 1-bit scoring kernel (``csrc/binary_ip.cu``).

Replaces ``repro.kernels.binary_ip.kernel.binary_ip_pallas``: (Q, d) ±1
int8 query signs × (D, d/32) packed document words → (Q, D) int32 sign
dots.  For CUDA tensors it packs the query signs into words on the device
and launches the XOR/popcount kernel (or raises); CPU tensors run
:func:`~repro_torch.kernels.binary_ip.ref.sign_dot_ref`.
"""

from __future__ import annotations

import torch

from repro_torch.core.quantization import pack_bits
from repro_torch.kernels import _build
from repro_torch.kernels.binary_ip.ref import sign_dot_ref

#: the launch puts query tiles of 64 rows on grid.y, which holds 65,535
MAX_QUERIES = 64 * 65535


def binary_ip(q_signs: torch.Tensor, docs_packed: torch.Tensor
              ) -> torch.Tensor:
    """(Q, d) ±1 int8 × (D, d/32) int32 words → (Q, D) int32 sign dots."""
    if q_signs.dtype != torch.int8 or docs_packed.dtype != torch.int32:
        raise TypeError(f"binary_ip takes int8 signs and int32 words, got "
                        f"{q_signs.dtype} and {docs_packed.dtype}")
    if q_signs.ndim != 2 or docs_packed.ndim != 2 \
            or q_signs.shape[1] != docs_packed.shape[1] * 32:
        raise ValueError(f"binary_ip: packed width {docs_packed.shape[-1]}"
                         f"*32 != d={q_signs.shape[-1]}")
    if q_signs.device != docs_packed.device:
        raise ValueError("binary_ip: signs and words on different devices")
    if q_signs.device.type == "cpu":
        return sign_dot_ref(q_signs, docs_packed)
    if q_signs.device.type != "cuda":
        raise ValueError(f"binary_ip: unsupported device {q_signs.device}")
    if q_signs.shape[0] > MAX_QUERIES:
        raise ValueError(f"binary_ip takes at most {MAX_QUERIES} queries a "
                         f"launch, got {q_signs.shape[0]}")
    q_words = pack_bits(q_signs).contiguous()
    docs = docs_packed.contiguous()
    n_q, n_words = q_words.shape
    n_docs = docs.shape[0]
    out = torch.empty((n_q, n_docs), dtype=torch.int32, device=docs.device)
    if n_q and n_docs:
        with torch.cuda.device(docs.device):
            _build.check(_build.library().binary_ip_launch(
                q_words.data_ptr(), docs.data_ptr(), out.data_ptr(), n_q,
                n_docs, n_words, _build.stream_handle(docs)), "binary_ip")
        binary_ip.launches += 1
    return out


binary_ip.launches = 0
