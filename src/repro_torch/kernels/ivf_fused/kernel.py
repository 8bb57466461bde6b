"""Wrapper of the fused IVF top-k kernel (``csrc/ivf_fused.cu``).

Replaces ``repro.kernels.ivf_fused.kernel.fused_ivf_topk_pallas``: per
query, gather its probed lists from the (nlist, L, w) list-major storage,
score them per backend, add the (Q, nprobe) base, mask pad ids and keep a
(Q, k) top-k in (score desc, id asc) order, unreachable slots (−inf, −1).
On the card the work runs list-major: the probe table is inverted, each
list is scored once for the (query, slot) pairs that probe it into a
(Q, nprobe, m) candidate buffer, and each query's candidates are merged
(``m`` from :func:`candidates_per_pair`).  CUDA tensors launch the kernels
(or raise); CPU tensors run
:func:`~repro_torch.kernels.ivf_fused.ref.fused_ivf_topk_ref`.
"""

from __future__ import annotations

import torch

from repro_torch import tracing
from repro_torch.kernels import _build
from repro_torch.kernels.ivf_fused.ref import BACKENDS, fused_ivf_topk_ref

#: the merge's running top-k sits in shared memory up to this k, and in a
#: global scratch of (Q, 2k) values and ids above it
MAX_K = 1024
#: a pair keeps its own top-k (in a warp's registers) up to this k
SELECT_K = 32
#: the buffers that grow with the queries (candidates, the global top-k
#: scratch, the outputs); larger query chunks are split
CHUNK_BYTES = 1 << 30
#: row width a launch takes: the group's queries sit in shared memory
MAX_WIDTH = {"float": 1024, "fp16": 1024, "int8": 2048, "onebit": 1024}

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


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def candidates_per_pair(k: int, max_len: int) -> int:
    """m, the candidates each (query, slot) pair hands to the merge: its
    top-k when k < L and k ≤ ``SELECT_K`` (chosen in a warp's registers),
    else every row of the list (which holds its top-min(k, L))."""
    return k if k < max_len and k <= SELECT_K else max_len


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
    nlist, max_len, w = list_storage.shape
    if w > MAX_WIDTH[backend]:
        raise ValueError(f"fused_ivf_topk[{backend}] takes rows of at most "
                         f"{MAX_WIDTH[backend]} elements on the card, got {w}")
    # 1-bit signs are packed into words by the kernel; int8 stays bf16
    q = qe if backend in ("onebit", "int8") else qe.float()
    q, probes, base = q.contiguous(), probes.contiguous(), base.contiguous()
    if q.data_ptr() % 4:                    # the kernel reads 4 bytes a load
        q = q.clone()
    storage, ids = list_storage.contiguous(), list_ids.contiguous()
    n_q, nprobe = probes.shape
    vals = torch.empty((n_q, k), dtype=torch.float32, device=q.device)
    out_ids = torch.empty((n_q, k), dtype=torch.int32, device=q.device)
    if not (n_q and nprobe and max_len):     # nothing reachable
        return vals.fill_(float("-inf")), out_ids.fill_(-1)
    m = candidates_per_pair(k, max_len)
    per_query = 8 * (nprobe * m + k + (2 * k if k > MAX_K else 0))
    chunk = max(1, min(n_q, CHUNK_BYTES // per_query))
    lib = _build.library()
    for s in range(0, n_q, chunk):
        e = min(n_q, s + chunk)
        nc = e - s
        work = torch.empty(lib.ivf_fused_work_ints(nc, nprobe, nlist),
                           dtype=torch.int32, device=q.device)
        cand_v = torch.empty((nc, nprobe, m), dtype=torch.float32,
                             device=q.device)
        cand_i = torch.empty((nc, nprobe, m), dtype=torch.int32,
                             device=q.device)
        scratch_v = scratch_i = None
        if k > MAX_K:
            scratch_v = torch.empty((nc, 2 * k), dtype=torch.float32,
                                    device=q.device)
            scratch_i = torch.empty((nc, 2 * k), dtype=torch.int32,
                                    device=q.device)
        with torch.cuda.device(q.device):
            _build.check(lib.ivf_fused_launch(
                probes[s:e].data_ptr(), q[s:e].data_ptr(), storage.data_ptr(),
                ids.data_ptr(), base[s:e].data_ptr(), vals[s:e].data_ptr(),
                out_ids[s:e].data_ptr(), work.data_ptr(), cand_v.data_ptr(),
                cand_i.data_ptr(), _ptr(scratch_v), _ptr(scratch_i), nc,
                nprobe, nlist, max_len, w, k, m, BACKENDS.index(backend),
                _build.stream_handle(q)),
                "fused_ivf_topk")
        tracing.count("fused_ivf_topk.launches")
    return vals, out_ids
