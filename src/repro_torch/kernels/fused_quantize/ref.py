"""Plain PyTorch version of the fused index-build encode.

The function ``csrc/fused_quantize.cu`` computes, written as four staged
passes in f32, as ``repro.kernels.fused_quantize.ref`` writes it:
center+normalize, the PCA product with its mean folded into μ₂′,
center+normalize, then the uint8 encode.  ``torch.round`` rounds half to
even, as ``jnp.round`` does.
"""

from __future__ import annotations

import torch


def fused_quantize_ref(x: torch.Tensor, mu1: torch.Tensor, w: torch.Tensor,
                       mu2: torch.Tensor, scale: torch.Tensor,
                       zero: torch.Tensor) -> torch.Tensor:
    """(N, d) float → (N, d′) uint8 codes."""
    x = x.float()
    y = x - mu1
    y = y / torch.sqrt(torch.sum(y * y, dim=-1, keepdim=True) + 1e-24)
    z = y @ w
    zc = z - mu2
    zc = zc / torch.sqrt(torch.sum(zc * zc, dim=-1, keepdim=True) + 1e-24)
    q = torch.round((zc - zero) / scale)
    return torch.clamp(q, 0.0, 255.0).to(torch.uint8)
