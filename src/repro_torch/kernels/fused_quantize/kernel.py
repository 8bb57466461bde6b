"""Wrapper of the fused index-build encode kernel (``csrc/fused_quantize.cu``).

Replaces ``repro.kernels.fused_quantize.kernel.fused_quantize_pallas``:
(N, d) f32 documents → (N, d′) uint8 codes through center+normalize, the
PCA product, center+normalize and the int8 encode, in one pass.  CUDA
tensors launch the kernel (or raise); CPU tensors run
:func:`~repro_torch.kernels.fused_quantize.ref.fused_quantize_ref`.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fused_quantize.ref import fused_quantize_ref

#: output columns a CTA covers per pass (16 a thread over 16 column
#: groups); wider outputs take several passes through an f32 scratch
PASS_D_OUT = 256


def fused_quantize(x: torch.Tensor, mu1: torch.Tensor, w: torch.Tensor,
                   mu2: torch.Tensor, scale: torch.Tensor,
                   zero: torch.Tensor) -> torch.Tensor:
    """(N, d) × (d, d′) → (N, d′) uint8; μ₁ (d,), μ₂′/scale/zero (d′,)."""
    if x.ndim != 2 or w.ndim != 2 or w.shape[0] != x.shape[1]:
        raise ValueError(f"fused_quantize shapes {tuple(x.shape)} × "
                         f"{tuple(w.shape)} do not match")
    d, d_out = w.shape
    if mu1.shape != (d,) or any(t.shape != (d_out,)
                                for t in (mu2, scale, zero)):
        raise ValueError("fused_quantize: μ₁ must be (d,) and μ₂′, scale, "
                         "zero (d′,)")
    if not x.is_floating_point():
        raise TypeError(f"fused_quantize takes float rows, got {x.dtype}")
    if len({t.device for t in (x, mu1, w, mu2, scale, zero)}) != 1:
        raise ValueError("fused_quantize: inputs on different devices")
    if x.device.type == "cpu":
        return fused_quantize_ref(x, mu1, w, mu2, scale, zero)
    if x.device.type != "cuda":
        raise ValueError(f"fused_quantize: unsupported device {x.device}")
    xs = x.float().contiguous()
    mu1, w, mu2, scale, zero = (t.float().contiguous()
                                for t in (mu1, w, mu2, scale, zero))
    n = xs.shape[0]
    out = torch.empty((n, d_out), dtype=torch.uint8, device=xs.device)
    scratch = (torch.empty((n, d_out), dtype=torch.float32, device=xs.device)
               if d_out > PASS_D_OUT else None)
    if n:
        with torch.cuda.device(xs.device):
            _build.check(_build.library().fused_quantize_launch(
                xs.data_ptr(), mu1.data_ptr(), w.data_ptr(), mu2.data_ptr(),
                scale.data_ptr(), zero.data_ptr(),
                None if scratch is None else scratch.data_ptr(),
                out.data_ptr(), n, d, d_out, _build.stream_handle(xs)),
                "fused_quantize")
        fused_quantize.launches += 1
    return out


fused_quantize.launches = 0
