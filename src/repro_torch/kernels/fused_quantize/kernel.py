"""Wrapper of the fused index-build encode kernel (``csrc/fused_quantize.cu``).

Replaces ``repro.kernels.fused_quantize.kernel.fused_quantize_pallas``:
(N, d) f32 documents → (N, d′) uint8 codes through center+normalize, the
PCA product, center+normalize and the int8 encode, in one pass, with the
product on the tensor cores as three bf16 products (W split into bf16 hi
and lo once a call by the kernel's pre-pass, as
:func:`~repro_torch.kernels.fused_quantize.ref.split_bf16` splits it).
CUDA tensors launch the kernel (or raise); CPU tensors run
:func:`~repro_torch.kernels.fused_quantize.ref.fused_quantize_ref`.
"""

from __future__ import annotations

import torch

from repro_torch import tracing
from repro_torch.kernels import _build
from repro_torch.kernels.fused_quantize.ref import fused_quantize_ref

#: output columns a pass covers; wider outputs take several passes through
#: an f32 scratch
PASS_D_OUT = 128
#: dims a pipeline stage covers: d is zero-padded to a multiple
K_CHUNK = 32
#: rows a CTA's tile covers
TILE_ROWS = 256


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


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
    dev = x.device
    xs = x.float().contiguous()
    mu1, w, mu2, scale, zero = (t.float().contiguous()
                                for t in (mu1, w, mu2, scale, zero))
    n = xs.shape[0]
    kp, dp = _round_up(d, K_CHUNK), _round_up(d_out, PASS_D_OUT)
    out = torch.empty((n, d_out), dtype=torch.uint8, device=dev)
    if not n:
        return out
    # the kernel's pre-pass writes Wᵀ split (hi, lo) and μ₁, μ₂′, scale
    # and zero padded here
    work = torch.empty(4 * dp * kp + 4 * kp + 12 * dp, dtype=torch.uint8,
                       device=dev)
    scratch = (torch.empty((n, dp), dtype=torch.float32, device=dev)
               if dp > PASS_D_OUT else None)
    with torch.cuda.device(dev):
        _build.check(_build.library().fused_quantize_launch(
            xs.data_ptr(), mu1.data_ptr(), w.data_ptr(), mu2.data_ptr(),
            scale.data_ptr(), zero.data_ptr(), work.data_ptr(),
            None if scratch is None else scratch.data_ptr(), out.data_ptr(),
            n, d, kp, d_out, dp, _build.stream_handle(xs)),
            "fused_quantize")
    tracing.count("fused_quantize.launches")
    return out
