"""Composable compression pipelines (the paper's full recipe as one object).

Counterpart of ``repro.core.pipeline``: an ordered list of transforms,
fitted in order (each stage sees its predecessors' output), applied in
order, serialized as per-stage state dicts, and reporting its storage
compression ratio.  Randomness comes from a ``torch.Generator``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.core import quantization as quant
from repro_torch.core.preprocess import Transform


class CompressionPipeline:
    def __init__(self, transforms: Sequence[Transform]):
        self.transforms = list(transforms)

    def fit(self, docs: torch.Tensor, queries: Optional[torch.Tensor] = None,
            rng: Optional[torch.Generator] = None) -> "CompressionPipeline":
        if rng is None:
            rng = torch.Generator().manual_seed(0)
        for t in self.transforms:
            t.fit(docs, queries, rng=rng)
            docs = t(docs, "docs")
            if queries is not None:
                queries = t(queries, "queries")
        return self

    def transform(self, x: torch.Tensor, kind: str = "docs") -> torch.Tensor:
        for t in self.transforms:
            x = t(x, kind)
        return x

    def __call__(self, x, kind="docs"):
        return self.transform(x, kind)

    def compression_ratio(self, input_dim: int) -> float:
        return quant.compression_ratio(input_dim, self.transforms)

    def output_dim(self, input_dim: int) -> int:
        for t in self.transforms:
            input_dim = t.output_dim(input_dim)
        return input_dim

    def state_dict(self) -> dict:
        return {"stages": [t.state_dict() for t in self.transforms],
                "types": [type(t).__name__ for t in self.transforms]}

    def load_state_dict(self, sd: dict,
                        device: Optional[torch.device] = None
                        ) -> "CompressionPipeline":
        types = sd.get("types")
        if types is not None:
            have = [type(t).__name__ for t in self.transforms]
            if have != list(types):
                raise ValueError(
                    f"pipeline stage mismatch: state dict has {list(types)}, "
                    f"object has {have}")
        if len(sd["stages"]) != len(self.transforms):
            raise ValueError(
                f"pipeline length mismatch: state dict has "
                f"{len(sd['stages'])} stages, object has "
                f"{len(self.transforms)}")
        for t, stage_sd in zip(self.transforms, sd["stages"]):
            t.load_state(stage_sd, device)
        return self

    def __repr__(self) -> str:
        inner = ", ".join(type(t).__name__ for t in self.transforms)
        return f"CompressionPipeline([{inner}])"
