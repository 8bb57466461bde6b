"""Principal component analysis for index compression (paper §4.2).

Counterpart of ``repro.core.pca``, the row-sharded fit
(:func:`fit_pca_distributed`) included.  PCA to 128 dims keeps ~94–96%
of retrieval performance; the covariance is estimated from moments that
add across batches and shards; component scaling down-weights the top-5
projections by (0.5, 0.8, 0.8, 0.9, 0.8).

``torch.linalg.eigh`` may return an eigenvector with the opposite sign to
``jnp.linalg.eigh``; fits are therefore compared with ``repro`` by the
subspace they span, never by bits.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.core.preprocess import Transform

# Paper §4.2: grid-searched scaling of the top-5 principal components.
PAPER_COMPONENT_SCALES: tuple[float, ...] = (0.5, 0.8, 0.8, 0.9, 0.8)


def moments(x: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-batch (count, sum, sum-of-outer-products) in float32."""
    x = x.float()
    n = torch.tensor(float(x.shape[0]), device=x.device)
    return n, torch.sum(x, dim=0), x.T @ x


def covariance_from_moments(n: torch.Tensor, s: torch.Tensor,
                            ss: torch.Tensor
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """(mean, covariance) from accumulated moments."""
    mean = s / n
    return mean, ss / n - torch.outer(mean, mean)


def fit_pca_from_cov(mean: torch.Tensor, cov: torch.Tensor, dim: int
                     ) -> dict[str, torch.Tensor]:
    """Eigendecompose a (d, d) covariance; keep top-``dim`` components,
    ordered by descending eigenvalue."""
    evals, evecs = torch.linalg.eigh(cov)          # ascending
    evals = evals.flip(0)[:dim]
    return {"mean": mean,
            "components": evecs.flip(1)[:, :dim].contiguous(),
            "eigenvalues": torch.clamp(evals, min=0.0)}


class PCA(Transform):
    """PCA projection ``x ↦ (x − μ) @ W`` with optional component scaling.

    ``fit_on`` ∈ {"docs", "queries", "both"} picks the population that
    estimates the covariance (paper Fig. 4); ``scale_components`` is
    ``None``, ``"paper"`` or explicit multipliers; ``max_fit_samples`` caps
    the fit set, drawn with the ``torch.Generator`` given to ``fit``.
    """

    name = "pca"
    state_keys = ("mean", "components", "eigenvalues")

    def __init__(self, dim: int, fit_on: str = "docs",
                 scale_components=None, max_fit_samples: Optional[int] = None):
        super().__init__()
        if fit_on not in ("docs", "queries", "both"):
            raise ValueError(f"fit_on must be docs|queries|both, got {fit_on}")
        self.dim = int(dim)
        self.fit_on = fit_on
        if scale_components == "paper":
            scale_components = PAPER_COMPONENT_SCALES
        self.scale_components = (
            tuple(float(s) for s in scale_components)
            if scale_components is not None else None)
        self.max_fit_samples = max_fit_samples

    def init_config(self):
        return {"dim": self.dim, "fit_on": self.fit_on,
                "scale_components": (list(self.scale_components)
                                     if self.scale_components is not None
                                     else None),
                "max_fit_samples": self.max_fit_samples}

    def _fit_set(self, docs, queries):
        if self.fit_on == "docs" or queries is None:
            return docs
        if self.fit_on == "queries":
            return queries
        return torch.cat([docs, queries], dim=0)

    def fit(self, docs, queries=None, rng=None):
        x = self._fit_set(docs, queries)
        if self.max_fit_samples is not None and x.shape[0] > self.max_fit_samples:
            if rng is None:
                rng = torch.Generator().manual_seed(0)
            idx = torch.randperm(x.shape[0], generator=rng)
            x = x[idx[: self.max_fit_samples].to(x.device)]
        return self.fit_from_moments(*moments(x))

    def fit_from_moments(self, n, s, ss):
        """Fit from pre-accumulated moments."""
        mean, cov = covariance_from_moments(n, s, ss)
        self.state = fit_pca_from_cov(mean, cov, self.dim)
        if self.scale_components is not None:
            k = min(len(self.scale_components), self.dim)
            scales = torch.ones(self.dim, device=mean.device)
            scales[:k] = torch.tensor(self.scale_components[:k])
            self.state["scales"] = scales
        self.fitted = True
        return self

    def projection_matrix(self) -> torch.Tensor:
        """(d, d') matrix including component scaling — single-GEMM apply."""
        w = self.state["components"]
        if "scales" in self.state:
            w = w * self.state["scales"][None, :]
        return w

    def __call__(self, x, kind="docs"):
        return (x - self.state["mean"]) @ self.projection_matrix()

    def inverse(self, z: torch.Tensor) -> torch.Tensor:
        """Approximate reconstruction (for reconstruction-loss analysis)."""
        if "scales" in self.state:
            z = z / self.state["scales"][None, :]
        return z @ self.state["components"].T + self.state["mean"]

    def output_dim(self, input_dim: int) -> int:
        return self.dim


def fit_pca_distributed(x_shards: Sequence[torch.Tensor], dim: int, mesh,
                        axis: str = "data") -> PCA:
    """Fit PCA on a row-sharded index without gathering it.

    ``x_shards`` holds one (n_i, d) row shard per position along ``axis``
    of ``mesh``, each on its own device.  Each shard computes its moments
    there; the (count, d, d×d) sums are added on the first shard's device
    in position order.  Cost: one pass over local rows plus ~d² floats
    moved a shard — independent of N.
    """
    n_pos = mesh.shape[axis]
    if len(x_shards) != n_pos:
        raise ValueError(f"{len(x_shards)} shards for the {n_pos} positions "
                         f"of axis {axis!r}")
    lead = x_shards[0].device
    total = None
    for x in x_shards:
        m = tuple(t.to(lead) for t in moments(x))
        total = m if total is None else tuple(a + b for a, b in zip(total, m))
    return PCA(dim).fit_from_moments(*total)
