"""Wrapper of the 1-bit scoring kernel (``csrc/binary_ip.cu``).

Replaces ``repro.kernels.binary_ip.kernel.binary_ip_pallas`` and the
×0.25 of ``repro.kernels.binary_ip.ops.binary_ip_scores``: (Q, d) ±1 int8
query signs × (D, d/32) packed document words → (Q, D) f32 scores
``0.25 · sign dot``.  For CUDA tensors it launches the tensor-core kernel
(or raises); CPU tensors (and meta tensors, in an abstract pass) run
:func:`~repro_torch.kernels.binary_ip.ref.binary_ip_ref`.
"""

from __future__ import annotations

import torch

from repro_torch import tracing
from repro_torch.kernels import _build
from repro_torch.kernels.binary_ip.ref import binary_ip_ref

#: the launch puts query tiles on grid.y, which holds 65,535; a tile holds
#: 128 queries up to 32 words, 64 up to 64 and 32 above
MAX_QUERIES = 32 * 65535
#: words a launch takes (the query signs' width sits in shared memory);
#: wider rows go in chunks, each launch adding its part to the scores
MAX_WORDS = 128


def binary_ip(q_signs: torch.Tensor, docs_packed: torch.Tensor
              ) -> torch.Tensor:
    """(Q, d) ±1 int8 × (D, d/32) int32 words → (Q, D) f32 0.25·dot."""
    if q_signs.dtype != torch.int8 or docs_packed.dtype != torch.int32:
        raise TypeError(f"binary_ip takes int8 signs and int32 words, got "
                        f"{q_signs.dtype} and {docs_packed.dtype}")
    if q_signs.ndim != 2 or docs_packed.ndim != 2 \
            or q_signs.shape[1] != docs_packed.shape[1] * 32:
        raise ValueError(f"binary_ip: packed width {docs_packed.shape[-1]}"
                         f"*32 != d={q_signs.shape[-1]}")
    if q_signs.device != docs_packed.device:
        raise ValueError("binary_ip: signs and words on different devices")
    if q_signs.device.type in ("cpu", "meta"):   # meta: an abstract pass
        return binary_ip_ref(q_signs, docs_packed)
    if q_signs.device.type != "cuda":
        raise ValueError(f"binary_ip: unsupported device {q_signs.device}")
    if q_signs.shape[0] > MAX_QUERIES:
        raise ValueError(f"binary_ip takes at most {MAX_QUERIES} queries a "
                         f"launch, got {q_signs.shape[0]}")
    q = q_signs.contiguous()
    if q.data_ptr() % 4:                    # the kernel reads 4 signs a load
        q = q.clone()
    docs = docs_packed if docs_packed.stride(-1) == 1 \
        else docs_packed.contiguous()
    n_q, n_docs = q.shape[0], docs.shape[0]
    n_words = docs.shape[1]
    out = torch.empty((n_q, n_docs), dtype=torch.float32, device=docs.device)
    if n_q and n_docs:
        lib = _build.library()
        with torch.cuda.device(docs.device):
            for w0 in range(0, n_words, MAX_WORDS):
                _build.check(lib.binary_ip_launch(
                    q.data_ptr() + 32 * w0, q.stride(0), docs.data_ptr()
                    + 4 * w0, docs.stride(0), out.data_ptr(), n_q, n_docs,
                    min(MAX_WORDS, n_words - w0), int(w0 > 0),
                    _build.stream_handle(docs)), "binary_ip")
                tracing.count("binary_ip.launches")
    return out
