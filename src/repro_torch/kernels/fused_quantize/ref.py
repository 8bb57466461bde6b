"""Plain PyTorch versions of the fused index-build encode.

:func:`fused_quantize_ref` is the function ``csrc/fused_quantize.cu``
computes, written as four staged passes in f32, as
``repro.kernels.fused_quantize.ref`` writes it: center+normalize, the PCA
product with its mean folded into μ₂′, center+normalize, then the uint8
encode.  ``torch.round`` rounds half to even, as ``jnp.round`` does.  The
kernel is held against it.

:func:`fused_quantize_split_ref` mirrors the kernel's own numerics, for the
tests: the product as three bf16 products (:func:`split_bf16`), each
normalize a multiply by the reciprocal of the norm, the first after the
product.
"""

from __future__ import annotations

import torch


def fused_normalize_ref(x: torch.Tensor, mu1: torch.Tensor, w: torch.Tensor,
                        mu2: torch.Tensor) -> torch.Tensor:
    """(N, d) float → the (N, d′) f32 rows that :func:`fused_quantize_ref`
    encodes: center+normalize, the product, center+normalize."""
    y = x.float() - mu1
    y = y / torch.sqrt(torch.sum(y * y, dim=-1, keepdim=True) + 1e-24)
    zc = y @ w - mu2
    return zc / torch.sqrt(torch.sum(zc * zc, dim=-1, keepdim=True) + 1e-24)


def fused_quantize_ref(x: torch.Tensor, mu1: torch.Tensor, w: torch.Tensor,
                       mu2: torch.Tensor, scale: torch.Tensor,
                       zero: torch.Tensor) -> torch.Tensor:
    """(N, d) float → (N, d′) uint8 codes."""
    zc = fused_normalize_ref(x, mu1, w, mu2)
    q = torch.round((zc - zero) / scale)
    return torch.clamp(q, 0.0, 255.0).to(torch.uint8)


def split_bf16(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 → (hi, lo) bf16, hi = bf16_rn(t), lo = bf16_rn(t − hi): hi + lo
    holds t to about 16 significant bits.  The kernel splits its rows so in
    registers; the wrapper splits W so, once a call."""
    t = t.float()
    hi = t.to(torch.bfloat16)
    return hi, (t - hi.float()).to(torch.bfloat16)


def _sum64(t: torch.Tensor) -> torch.Tensor:
    return torch.sum(t.double() ** 2, dim=-1, keepdim=True).float()


def fused_quantize_split_ref(x: torch.Tensor, mu1: torch.Tensor,
                             w: torch.Tensor, mu2: torch.Tensor,
                             scale: torch.Tensor,
                             zero: torch.Tensor) -> torch.Tensor:
    """(N, d) float → (N, d′) uint8 codes, with the kernel's numerics:

        y  = x − μ₁;  ss₁ = Σ y²          (of the f32 y, not its parts)
        z  = (y_hi·W_hi + y_lo·W_hi + y_hi·W_lo) · (1 / sqrt(ss₁ + 1e-24))
             − μ₂′
        w  = z · (1 / sqrt(Σ z² + 1e-24))
        u  = clip(rint((w − zero) / scale))

    The normalizes multiply by a reciprocal, as the Pallas kernel
    multiplies by ``rsqrt``; the encode divides.  Each bf16 product is
    exact; the products and the sums of squares are summed in f64 and
    rounded once to f32, so a row's codes do not depend on the batch (an
    f32 BLAS sums in an order that changes with the row count).  The
    kernel sums in f32 on the tensor cores, so the two differ only by the
    order of f32 sums.  For tests; the kernel is held against
    :func:`fused_quantize_ref`.
    """
    y = x.float() - mu1
    yh, yl = (t.double() for t in split_bf16(y))
    wh, wl = (t.double() for t in split_bf16(w))
    prod = (yh @ wh + yl @ wh + yh @ wl).float()
    z = prod * (1.0 / torch.sqrt(_sum64(y) + 1e-24)) - mu2
    zc = z * (1.0 / torch.sqrt(_sum64(z) + 1e-24))
    q = torch.round((zc - zero) / scale)
    return torch.clamp(q, 0.0, 255.0).to(torch.uint8)
