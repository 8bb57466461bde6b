"""Wrapper of the int8 scoring kernel (``csrc/int8_ip.cu``).

Replaces ``repro.kernels.int8_ip.kernel.int8_ip_pallas``: (Q, d) bf16
queries pre-scaled by the codebook × (D, d) uint8 codes (+ an optional
(Q,) f32 ``bias``, added in the kernel's epilogue) → (Q, D) f32.  CUDA
tensors launch the kernel (or raise); CPU tensors, and meta tensors in
an abstract pass, run :func:`~repro_torch.kernels.int8_ip.ref.int8_ip_ref`.
"""

from __future__ import annotations

import torch

from repro_torch import tracing
from repro_torch.kernels import _build
from repro_torch.kernels.int8_ip.ref import int8_ip_ref

#: the launch puts query tiles on grid.y, which holds 65,535; a tile holds
#: 128 queries up to d = 256, 64 up to 512 and 32 above
MAX_QUERIES = 32 * 65535
#: the queries' whole width sits in shared memory
MAX_DIM = 2048


def int8_ip(q_scaled: torch.Tensor, docs_u8: torch.Tensor,
            bias: torch.Tensor | None = None) -> torch.Tensor:
    """(Q, d) bf16 × (D, d) uint8 (+ bias[:, None]) → (Q, D) f32."""
    if q_scaled.dtype != torch.bfloat16 or docs_u8.dtype != torch.uint8:
        raise TypeError(f"int8_ip takes bf16 queries and uint8 codes, got "
                        f"{q_scaled.dtype} and {docs_u8.dtype}")
    if q_scaled.ndim != 2 or docs_u8.ndim != 2 \
            or q_scaled.shape[1] != docs_u8.shape[1]:
        raise ValueError(f"int8_ip shapes {tuple(q_scaled.shape)} × "
                         f"{tuple(docs_u8.shape)} do not match")
    if q_scaled.device != docs_u8.device:
        raise ValueError("int8_ip: queries and codes on different devices")
    if bias is not None and (bias.dtype != torch.float32
                             or bias.shape != (q_scaled.shape[0],)
                             or bias.device != q_scaled.device):
        raise ValueError(f"int8_ip: bias must be ({q_scaled.shape[0]},) "
                         f"float32 on {q_scaled.device}, got {bias.dtype} "
                         f"{tuple(bias.shape)} on {bias.device}")
    if q_scaled.device.type in ("cpu", "meta"):   # meta: an abstract pass
        return int8_ip_ref(q_scaled, docs_u8, bias)
    if q_scaled.device.type != "cuda":
        raise ValueError(f"int8_ip: unsupported device {q_scaled.device}")
    if q_scaled.shape[0] > MAX_QUERIES:
        raise ValueError(f"int8_ip takes at most {MAX_QUERIES} queries a "
                         f"launch, got {q_scaled.shape[0]}")
    if q_scaled.shape[1] > MAX_DIM:
        raise ValueError(f"int8_ip takes d ≤ {MAX_DIM} on the card, got "
                         f"{q_scaled.shape[1]}")
    q, docs = q_scaled.contiguous(), docs_u8.contiguous()
    b = bias.contiguous() if bias is not None else None
    n_q, d = q.shape
    n_docs = docs.shape[0]
    out = torch.empty((n_q, n_docs), dtype=torch.float32, device=q.device)
    if n_q and n_docs:
        with torch.cuda.device(q.device):
            _build.check(_build.library().int8_ip_launch(
                q.data_ptr(), docs.data_ptr(),
                b.data_ptr() if b is not None else None, out.data_ptr(), n_q,
                n_docs, d, _build.stream_handle(q)), "int8_ip")
        tracing.count("int8_ip.launches")
    return out
