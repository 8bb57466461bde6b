"""Pre/post-processing transforms (paper §3.3, Appendix A).

Center then normalize, both before and after dimension reduction, with the
statistics computed for queries and documents separately.  Every transform
follows the two-population convention: ``fit`` receives (docs, queries)
and stores per-population statistics; ``__call__`` takes ``kind`` ∈
{"docs", "queries"}.  Counterpart of ``repro.core.preprocess``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


def as_tensor(v, device: Optional[torch.device] = None) -> torch.Tensor:
    """numpy array / tensor / scalar → tensor on ``device`` (bytes kept)."""
    if isinstance(v, torch.Tensor):
        return v.to(device) if device is not None else v
    return torch.from_numpy(np.array(v)).to(device)


class Transform:
    """Base class for fit/apply index transforms.

    Subclasses implement :meth:`fit` and :meth:`__call__`.  All state lives
    in ``self.state`` as a dict of tensors, so pipelines serialize
    uniformly and artifacts carry it across to and from ``repro``.
    """

    name: str = "identity"

    #: state keys that must be present once fitted — ``load_state`` refuses
    #: an incomplete dict instead of producing a broken transform.
    state_keys: tuple[str, ...] = ()

    def __init__(self) -> None:
        self.state: dict[str, torch.Tensor] = {}
        self.fitted = False

    def init_config(self) -> dict:
        """JSON-serializable constructor kwargs of an equivalent instance."""
        return {}

    def fit(self, docs: torch.Tensor, queries: Optional[torch.Tensor] = None,
            rng: Optional[torch.Generator] = None) -> "Transform":
        self.fitted = True
        return self

    def __call__(self, x: torch.Tensor, kind: str = "docs") -> torch.Tensor:
        return x

    def output_dim(self, input_dim: int) -> int:
        return input_dim

    def bits_per_dim(self, bits_in: float) -> float:
        """Storage bits per dimension after this transform (32.0 for fp32)."""
        return bits_in

    def state_dict(self) -> dict:
        return {"name": self.name, "state": dict(self.state),
                "fitted": self.fitted}

    def load_state(self, sd: dict,
                   device: Optional[torch.device] = None) -> "Transform":
        """Load state (tensors or numpy arrays) onto ``device``."""
        fitted = bool(sd["fitted"])
        if fitted:
            missing = set(self.state_keys) - set(sd["state"])
            if missing:
                raise ValueError(
                    f"{type(self).__name__}.load_state: fitted state is "
                    f"missing keys {sorted(missing)} "
                    f"(have {sorted(sd['state'])})")
        self.state = {k: as_tensor(v, device) for k, v in sd["state"].items()}
        self.fitted = fitted
        return self

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"{type(self).__name__}(fitted={self.fitted})"


def _mean(x: torch.Tensor) -> torch.Tensor:
    return torch.mean(x.float(), dim=0)


def _std(x: torch.Tensor) -> torch.Tensor:
    return torch.std(x.float(), dim=0, correction=0) + 1e-12


def _l2_normalize(y: torch.Tensor) -> torch.Tensor:
    # clamp, not +eps: the same numerics as repro's max(norm, 1e-12)
    norm = torch.linalg.vector_norm(y, dim=-1, keepdim=True)
    return y / torch.clamp(norm, min=1e-12)


class Center(Transform):
    """x ← x − mean;   means estimated separately for docs and queries."""

    name = "center"
    state_keys = ("mean_docs", "mean_queries")

    def fit(self, docs, queries=None, rng=None):
        self.state["mean_docs"] = _mean(docs)
        self.state["mean_queries"] = (
            _mean(queries) if queries is not None else self.state["mean_docs"])
        self.fitted = True
        return self

    def __call__(self, x, kind="docs"):
        mean = self.state["mean_queries" if kind == "queries" else "mean_docs"]
        return x - mean


class Normalize(Transform):
    """x ← x / ||x||₂  (row-wise; stateless)."""

    name = "normalize"

    def __call__(self, x, kind="docs"):
        return _l2_normalize(x)


class ZScore(Transform):
    """x ← (x − mean) / std  (per-dimension; includes centering, App. A)."""

    name = "zscore"
    state_keys = ("mean_docs", "std_docs", "mean_queries", "std_queries")

    def fit(self, docs, queries=None, rng=None):
        self.state["mean_docs"] = _mean(docs)
        self.state["std_docs"] = _std(docs)
        if queries is not None:
            self.state["mean_queries"] = _mean(queries)
            self.state["std_queries"] = _std(queries)
        else:
            self.state["mean_queries"] = self.state["mean_docs"]
            self.state["std_queries"] = self.state["std_docs"]
        self.fitted = True
        return self

    def __call__(self, x, kind="docs"):
        sfx = "queries" if kind == "queries" else "docs"
        return (x - self.state[f"mean_{sfx}"]) / self.state[f"std_{sfx}"]


class CenterNorm(Center):
    """The paper's recommended composite: center then L2-normalize."""

    name = "center_norm"

    def __call__(self, x, kind="docs"):
        return _l2_normalize(super().__call__(x, kind))


@dataclasses.dataclass(frozen=True)
class PreprocessSpec:
    """Declarative pre/post-processing configuration.

    ``mode`` ∈ {"none", "center", "norm", "center_norm", "zscore",
    "zscore_norm"} — the rows of paper Table 5.
    """

    mode: str = "center_norm"

    def build(self) -> list[Transform]:
        table = {"none": [], "center": [Center], "norm": [Normalize],
                 "center_norm": [CenterNorm], "zscore": [ZScore],
                 "zscore_norm": [ZScore, Normalize]}
        if self.mode not in table:
            raise ValueError(f"unknown preprocess mode: {self.mode!r}")
        return [cls() for cls in table[self.mode]]
