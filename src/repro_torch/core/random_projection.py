"""Random-projection dimension reduction (paper §4.1).

Counterpart of ``repro.core.random_projection``.  Four methods, in the
paper's increasing order of quality:

* sparse random projection  (Achlioptas ±√3 entries, density 1/3)
* Gaussian random projection
* random dimension dropping (keep a random subset of coordinates)
* greedy dimension dropping (score each dimension by the retrieval quality
  when it alone is removed; keep the most useful) — deterministic given
  its scorer, and the best of the family (Table 2).

Draws come from the ``torch.Generator`` given to ``fit`` (default: the
CPU generator seeded 0), on the generator's device, and the result moves
to the data's.  They are not ``jax.random``'s draws, so a fit is held to
``repro``'s by what it is: ``keep`` a sorted set of distinct indices,
Gaussian entries of variance 1/d′, sparse entries in {0, ±√(s/d′)} at
density 1/s.  ``keep`` is int32, as ``repro`` stores it.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core.preprocess import Transform


def _generator(rng: Optional[torch.Generator]) -> torch.Generator:
    return rng if rng is not None else torch.Generator().manual_seed(0)


def _take(x: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    return torch.index_select(x, -1, keep.to(x.device).long())


def _sorted_keep(keep: torch.Tensor, device) -> torch.Tensor:
    return torch.sort(keep).values.to(device=device, dtype=torch.int32)


class DimensionDrop(Transform):
    """Keep a random subset of d' coordinates (paper f_drop)."""

    name = "dim_drop"
    state_keys = ("keep",)

    def __init__(self, dim: int):
        super().__init__()
        self.dim = int(dim)

    def init_config(self):
        return {"dim": self.dim}

    def fit(self, docs, queries=None, rng=None):
        rng = _generator(rng)
        perm = torch.randperm(docs.shape[-1], generator=rng, device=rng.device)
        self.state["keep"] = _sorted_keep(perm[: self.dim], docs.device)
        self.fitted = True
        return self

    def __call__(self, x, kind="docs"):
        return _take(x, self.state["keep"])

    def output_dim(self, input_dim):
        return self.dim


class GreedyDimensionDrop(Transform):
    """One-shot greedy selection of the d' most retrieval-useful dimensions.

    Paper §4.1: for each dimension i, evaluate retrieval quality with i
    removed; keep the d' dimensions whose removal hurts most.  The scorer
    is injected (``scorer(queries, docs) → (d,)`` quality without each
    dimension, e.g. :func:`repro_torch.retrieval.rprecision.
    make_dim_drop_scorer`).  Qualities are R-Precision values, so ties
    are the rule: the stable ascending order keeps the lowest dimension
    first among equals, as ``jnp.argsort`` does.
    """

    name = "greedy_dim_drop"
    state_keys = ("keep",)

    def __init__(self, dim: int,
                 scorer: Optional[Callable[[torch.Tensor, torch.Tensor],
                                           torch.Tensor]] = None,
                 max_eval_queries: int = 512, max_eval_docs: int = 16384):
        super().__init__()
        self.dim = int(dim)
        self.scorer = scorer
        self.max_eval_queries = max_eval_queries
        self.max_eval_docs = max_eval_docs

    def init_config(self):
        # the scorer is a callable, not serializable: a reloaded instance
        # applies its fitted "keep" but needs a fresh scorer to re-fit
        return {"dim": self.dim, "max_eval_queries": self.max_eval_queries,
                "max_eval_docs": self.max_eval_docs}

    def fit(self, docs, queries=None, rng=None):
        if self.scorer is None:
            raise ValueError("GreedyDimensionDrop needs a scorer; use "
                             "repro_torch.retrieval.rprecision."
                             "make_dim_drop_scorer")
        losses = self.scorer(queries, docs)    # (d,) quality WITHOUT dim i
        # quality with i removed is LOW for important dims → keep ascending
        order = torch.argsort(losses, stable=True)
        self.state["keep"] = _sorted_keep(order[: self.dim], docs.device)
        self.state["per_dim_quality"] = losses
        self.fitted = True
        return self

    def __call__(self, x, kind="docs"):
        return _take(x, self.state["keep"])

    def output_dim(self, input_dim):
        return self.dim


class GaussianProjection(Transform):
    """x ↦ x @ R,  R_ij ~ N(0, 1/d')."""

    name = "gaussian_projection"
    state_keys = ("matrix",)

    def __init__(self, dim: int):
        super().__init__()
        self.dim = int(dim)

    def init_config(self):
        return {"dim": self.dim}

    def fit(self, docs, queries=None, rng=None):
        rng = _generator(rng)
        r = torch.randn((docs.shape[-1], self.dim), generator=rng,
                        device=rng.device)
        r = r / torch.sqrt(torch.tensor(float(self.dim)))
        self.state["matrix"] = r.to(docs.device)
        self.fitted = True
        return self

    def __call__(self, x, kind="docs"):
        return x @ self.state["matrix"]

    def output_dim(self, input_dim):
        return self.dim


class SparseProjection(Transform):
    """Achlioptas sparse random projection.

    R_ij = ±√(s/d') with prob 1/(2s) each, 0 with prob 1−1/s  (s = 3).
    """

    name = "sparse_projection"
    state_keys = ("matrix",)

    def __init__(self, dim: int, s: float = 3.0):
        super().__init__()
        self.dim = int(dim)
        self.s = float(s)

    def init_config(self):
        return {"dim": self.dim, "s": self.s}

    def fit(self, docs, queries=None, rng=None):
        rng = _generator(rng)
        shape = (docs.shape[-1], self.dim)
        signs = torch.randint(0, 2, shape, generator=rng,
                              device=rng.device).float() * 2 - 1
        mask = torch.rand(shape, generator=rng, device=rng.device) \
            < 1.0 / self.s
        # √(s/d′) in f32, the value repro's entries take
        scale = torch.sqrt(torch.tensor(self.s / self.dim))
        self.state["matrix"] = (signs * mask.float() * scale).to(docs.device)
        self.fitted = True
        return self

    def __call__(self, x, kind="docs"):
        return x @ self.state["matrix"]

    def output_dim(self, input_dim):
        return self.dim
