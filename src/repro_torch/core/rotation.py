"""OPQ-style learned rotation before 1-bit quantization.

Counterpart of ``repro.core.rotation``.  An orthogonal R keeps every inner
product (q·x = (qR)·(xR)) but re-aims the sign grid at the data; R is
learned by alternating ``B ← Q(XR)`` and the orthogonal Procrustes step
``R ← U Vᵀ`` with ``U Σ Vᵀ = XᵀB`` (Ge et al., CVPR 2013).  The SVD is
``torch.linalg.svd`` in f32, whose singular vectors may differ in sign from
``jnp.linalg.svd``'s, so a fit is compared with ``repro``'s by what it does
(orthogonality, binarisation error), never by bits.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.preprocess import Transform


def _sign_targets(z: torch.Tensor, offset: float) -> torch.Tensor:
    """Q(z) for the offset-α 1-bit codebook: 1 − α where z ≥ 0, else −α."""
    return torch.where(z >= 0.0, 1.0 - offset, -offset)


class LearnedRotation(Transform):
    """Learn an orthogonal rotation minimising 1-bit quantization error.

    Applied identically to docs and queries: a per-population rotation
    would break the q·x = (qR)·(xR) identity.  A fit set larger than
    ``max_fit_samples`` is subsampled with the ``torch.Generator`` given
    to ``fit``.
    """

    name = "learned_rotation"
    state_keys = ("rotation",)

    def __init__(self, n_iters: int = 10, offset: float = 0.5,
                 max_fit_samples: Optional[int] = 65536):
        super().__init__()
        self.n_iters = int(n_iters)
        self.offset = float(offset)
        self.max_fit_samples = max_fit_samples

    def init_config(self):
        return {"n_iters": self.n_iters, "offset": self.offset,
                "max_fit_samples": self.max_fit_samples}

    def fit(self, docs, queries=None, rng=None):
        x = docs.float()
        if self.max_fit_samples is not None and \
                x.shape[0] > self.max_fit_samples:
            if rng is None:
                rng = torch.Generator().manual_seed(0)
            idx = torch.randperm(x.shape[0], generator=rng,
                                 device=rng.device)
            x = x[idx[: self.max_fit_samples].to(x.device)]
        r = torch.eye(x.shape[-1], device=x.device)
        for _ in range(self.n_iters):
            b = _sign_targets(x @ r, self.offset)
            u, _, vt = torch.linalg.svd(x.T @ b, full_matrices=False)
            r = u @ vt
        self.state = {"rotation": r}
        self.fitted = True
        return self

    def __call__(self, x, kind="docs"):
        return x @ self.state["rotation"]

    def inverse(self, z: torch.Tensor) -> torch.Tensor:
        return z @ self.state["rotation"].T
