"""Wrapper of the fused IVF top-k kernel (``csrc/ivf_fused.cu``).

Replaces ``repro.kernels.ivf_fused.kernel.fused_ivf_topk_pallas``: per
query, gather its probed lists from the (nlist, L, w) list-major storage,
score them per backend, add the (Q, nprobe) base, mask pad ids and keep a
(Q, k) top-k in (score desc, id asc) order, unreachable slots (−inf, −1).
CUDA tensors launch the kernel (or raise); CPU tensors run
:func:`~repro_torch.kernels.ivf_fused.ref.fused_ivf_topk_ref`.
"""

from __future__ import annotations

import torch

from repro_torch.core.quantization import pack_bits
from repro_torch.kernels import _build
from repro_torch.kernels.ivf_fused.ref import BACKENDS, fused_ivf_topk_ref

#: the running top-k sits in shared memory up to this k, and in a global
#: scratch of (Q, 2k) values and ids above it
MAX_K = 1024

#: backend → (list storage dtype, encoded query dtype)
_DTYPES = {
    "float": (torch.float32, torch.float32),
    "fp16": (torch.float16, torch.float32),
    "int8": (torch.uint8, torch.bfloat16),
    "onebit": (torch.int32, torch.int8),
}


def _check(probes, qe, list_storage, list_ids, base, k, backend) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown fused backend {backend!r}")
    if k < 1:
        raise ValueError(f"k must be ≥ 1, got {k}")
    store_dt, q_dt = _DTYPES[backend]
    if probes.dtype != torch.int32 or list_ids.dtype != torch.int32 \
            or base.dtype != torch.float32 or list_storage.dtype != store_dt \
            or qe.dtype != q_dt:
        raise TypeError(
            f"fused_ivf_topk[{backend}] takes int32 probes and ids, f32 "
            f"base, {store_dt} storage and {q_dt} queries; got "
            f"{probes.dtype}, {list_ids.dtype}, {base.dtype}, "
            f"{list_storage.dtype}, {qe.dtype}")
    if probes.ndim != 2 or qe.ndim != 2 or list_storage.ndim != 3:
        raise ValueError("fused_ivf_topk needs 2-D probes and queries and "
                         "3-D list storage")
    nlist, max_len, w = list_storage.shape
    dq = 32 * w if backend == "onebit" else w
    if list_ids.shape != (nlist, max_len) or base.shape != probes.shape \
            or qe.shape != (probes.shape[0], dq):
        raise ValueError(
            f"fused_ivf_topk shapes do not match: probes "
            f"{tuple(probes.shape)}, queries {tuple(qe.shape)}, storage "
            f"{tuple(list_storage.shape)}, ids {tuple(list_ids.shape)}, "
            f"base {tuple(base.shape)}")
    devices = {t.device for t in (probes, qe, list_storage, list_ids, base)}
    if len(devices) != 1:
        raise ValueError("fused_ivf_topk: inputs on different devices")


def fused_ivf_topk(probes: torch.Tensor, qe: torch.Tensor,
                   list_storage: torch.Tensor, list_ids: torch.Tensor,
                   base: torch.Tensor, k: int, backend: str
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(Q, nprobe) probes, (Q, dq) encoded queries (f32 / bf16 q⊙scale /
    ±1 int8 signs), (nlist, L, w) storage, (nlist, L) ids, (Q, nprobe) f32
    base → (Q, k) f32 values and int32 ids."""
    _check(probes, qe, list_storage, list_ids, base, k, backend)
    if qe.device.type == "cpu":
        return fused_ivf_topk_ref(probes, qe, list_storage, list_ids, base,
                                  k, backend)
    if qe.device.type != "cuda":
        raise ValueError(f"fused_ivf_topk: unsupported device {qe.device}")
    q = (pack_bits(qe) if backend == "onebit" else qe.float()).contiguous()
    probes, base = probes.contiguous(), base.contiguous()
    storage, ids = list_storage.contiguous(), list_ids.contiguous()
    n_q, nprobe = probes.shape
    nlist, max_len, w = storage.shape
    vals = torch.empty((n_q, k), dtype=torch.float32, device=q.device)
    out_ids = torch.empty((n_q, k), dtype=torch.int32, device=q.device)
    scratch_v = scratch_i = None
    if k > MAX_K:
        scratch_v = torch.empty((n_q, 2 * k), dtype=torch.float32,
                                device=q.device)
        scratch_i = torch.empty((n_q, 2 * k), dtype=torch.int32,
                                device=q.device)
    if n_q:
        with torch.cuda.device(q.device):
            _build.check(_build.library().ivf_fused_launch(
                probes.data_ptr(), q.data_ptr(), storage.data_ptr(),
                ids.data_ptr(), base.data_ptr(), vals.data_ptr(),
                out_ids.data_ptr(),
                None if scratch_v is None else scratch_v.data_ptr(),
                None if scratch_i is None else scratch_i.data_ptr(),
                n_q, nprobe, nlist, max_len, w, k, BACKENDS.index(backend),
                _build.stream_handle(q)), "fused_ivf_topk")
        fused_ivf_topk.launches += 1
    return vals, out_ids


fused_ivf_topk.launches = 0
