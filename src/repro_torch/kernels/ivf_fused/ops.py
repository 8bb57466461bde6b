"""Public op: fused IVF top-k over probed lists, any scorer backend.

Counterpart of ``repro.kernels.ivf_fused.ops``.  Encodes the float queries
for the backend (the document side is the list-major storage that
:class:`~repro_torch.retrieval.ivf.IVFIndex` prepares once) and folds the
score terms that are affine in the query — int8's ``q·zero``, residual
encoding's routed ``q·centroid`` — into the per-(query, probe) ``base``,
so the kernel adds one scalar per list.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.ivf_fused import kernel as _kernel


def prepare_queries(q: torch.Tensor, backend: str, params: dict, *,
                    packed_width: Optional[int] = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Float queries (after the float stages) → (qe, base_q).

    ``base_q`` (Q,) is the query-only additive term: int8's ``q·zero``,
    zero otherwise.  1-bit signs are padded with −1 to the packed width,
    as the encoder pads documents.
    """
    q = q.float()
    zero_base = torch.zeros((q.shape[0],), device=q.device)
    if backend in ("float", "fp16"):
        return q, zero_base
    if backend == "int8":
        qe = (q * params["scale"]).to(torch.bfloat16)
        return qe, q @ params["zero"]
    if backend == "onebit":
        if packed_width is None:
            raise ValueError("onebit queries need packed_width")
        signs = torch.where(q >= 0, 1, -1).to(torch.int8)
        pad = packed_width * 32 - signs.shape[-1]
        if pad:
            signs = F.pad(signs, (0, pad), value=-1)
        return signs, zero_base
    raise ValueError(f"unknown fused backend {backend!r}")


def fused_ivf_topk(probes: torch.Tensor, q: torch.Tensor,
                   list_storage: torch.Tensor, list_ids: torch.Tensor,
                   k: int, backend: str, params: Optional[dict] = None,
                   extra_base: Optional[torch.Tensor] = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(Q, k) top-k over the probed lists; float queries in, ids out.

    ``extra_base`` (Q, nprobe) adds a per-(query, probe) score term (the
    residual encoding's routed centroid score).
    """
    params = params or {}
    packed_width = list_storage.shape[-1] if backend == "onebit" else None
    qe, base_q = prepare_queries(q, backend, params,
                                 packed_width=packed_width)
    base = base_q[:, None].expand(probes.shape).float()
    if extra_base is not None:
        base = base + extra_base.float()
    return _kernel.fused_ivf_topk(probes.to(torch.int32), qe, list_storage,
                                  list_ids, base, k, backend)
