"""Scorer backends: the storage representation of an index and how float
queries are scored against it.

Counterpart of ``repro.retrieval.scorers``.  A :class:`Scorer` owns the
encoding of documents (float / fp16 / uint8 codes / packed words) and
scores queries through the matching path: with kernel numerics (the
Hopper kernels on CUDA tensors, their plain versions on CPU tensors) or
with ``repro``'s jnp numerics in plain torch.  ``backend`` ∈ {"auto",
"torch", "kernel"}; "auto" resolves by the storage's device (see
:mod:`repro_torch.utils`).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core.pipeline import CompressionPipeline
from repro_torch.core.preprocess import Transform
from repro_torch.core.quantization import (FloatCast, Int8Quantizer,
                                           OneBitQuantizer)
from repro_torch.retrieval.topk import similarity, similarity_gathered
from repro_torch.utils import check_backend, use_kernel


class Scorer:
    """Base scorer: float storage, plain GEMM similarity."""

    name = "float"

    def __init__(self, sim: str = "ip", backend: str = "auto"):
        self.sim = sim
        self.backend = check_backend(backend)

    def use_kernel(self, storage: torch.Tensor) -> bool:
        """Kernel numerics for storage on this device?"""
        return use_kernel(self.backend, storage.device)

    def encode_docs(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def encode_queries(self, q: torch.Tensor) -> torch.Tensor:
        return q

    def params(self) -> dict[str, torch.Tensor]:
        """Tensors ``scores`` reads (quantizer codebooks)."""
        return {}

    def scores(self, q: torch.Tensor, storage: torch.Tensor,
               params: Optional[dict] = None) -> torch.Tensor:
        return similarity(q, storage, self.sim)

    def scores_gathered(self, q: torch.Tensor, gathered: torch.Tensor,
                        params: Optional[dict] = None) -> torch.Tensor:
        """(Q, d) × (Q, C, w) → (Q, C): each query against its own
        candidate rows (IVF's gathered lists), with the numerics of
        :meth:`scores`.  ``repro`` vmaps ``scores`` over the queries; here
        the batch dimension is written out."""
        return similarity_gathered(q, self.decode(gathered), self.sim)

    def extra_state(self) -> dict:
        """Scorer-owned scalars outside the quantizer's state (artifact
        format; codebooks live in the pipeline's stage state already)."""
        return {}

    def load_extra_state(self, sd: dict) -> None:
        pass

    def decode(self, storage: torch.Tensor) -> torch.Tensor:
        return storage

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"{type(self).__name__}(sim={self.sim!r}, backend={self.backend!r})"


class FloatCastScorer(Scorer):
    """fp16/bf16 storage; scoring upcasts (callers cache the view)."""

    name = "fp16"

    def __init__(self, quantizer: FloatCast, sim: str = "ip",
                 backend: str = "auto"):
        super().__init__(sim=sim, backend=backend)
        self.quantizer = quantizer

    def encode_docs(self, x):
        return self.quantizer.encode(x, "docs")

    def scores(self, q, storage, params=None):
        return similarity(q, self.quantizer.decode(storage), self.sim)

    def decode(self, storage):
        return self.quantizer.decode(storage)


class Int8Scorer(Scorer):
    """uint8 codes; the affine decode is folded into the int8 kernel."""

    name = "int8"

    def __init__(self, quantizer: Int8Quantizer, sim: str = "ip",
                 backend: str = "auto"):
        super().__init__(sim=sim, backend=backend)
        self.quantizer = quantizer

    def encode_docs(self, x):
        return self.quantizer.encode(x, "docs")

    def params(self):
        return {"scale": self.quantizer.state["scale"],
                "zero": self.quantizer.state["zero"]}

    def scores(self, q, storage, params=None):
        from repro_torch.kernels.int8_ip import ops as int8_ops
        p = params if params is not None else self.params()
        return int8_ops.int8_scores(q, storage, scale=p["scale"],
                                    zero=p["zero"], sim=self.sim,
                                    use_kernel=self.use_kernel(storage))

    def scores_gathered(self, q, gathered, params=None):
        from repro_torch.kernels.int8_ip import ops as int8_ops
        p = params if params is not None else self.params()
        return int8_ops.int8_scores_gathered(
            q, gathered, scale=p["scale"], zero=p["zero"], sim=self.sim,
            use_kernel=self.use_kernel(gathered))

    def decode(self, storage):
        return self.quantizer.decode(storage)


class OneBitScorer(Scorer):
    """Packed int32 sign words; XOR/popcount kernel scoring.

    ``dim`` is the logical (unpadded) float dimensionality, recorded at
    ``encode_docs`` time; the packed words round it up to a multiple of 32.
    """

    name = "onebit"

    def __init__(self, quantizer: OneBitQuantizer, sim: str = "ip",
                 backend: str = "auto", dim: Optional[int] = None):
        super().__init__(sim=sim, backend=backend)
        self.quantizer = quantizer
        self.dim = dim

    def extra_state(self):
        return {"dim": self.dim}

    def load_extra_state(self, sd):
        if sd.get("dim") is not None:
            self.dim = int(sd["dim"])

    def encode_docs(self, x):
        self.dim = int(x.shape[-1])
        return self.quantizer.encode(x, "docs")

    def encode_queries(self, q):
        # offset-encoded floats, as repro: only their signs reach the
        # kernel, and the offset terms are added in binary_ip_scores
        return self.quantizer(q, "queries")

    def scores(self, q, storage, params=None):
        from repro_torch.kernels.binary_ip import ops as binary_ops
        if self.dim is None:
            raise ValueError("OneBitScorer.dim unset — encode_docs first or "
                             "pass dim= at construction")
        return binary_ops.binary_ip_scores(
            q, storage, self.dim, offset=self.quantizer.offset,
            use_kernel=self.use_kernel(storage))

    def scores_gathered(self, q, gathered, params=None):
        from repro_torch.kernels.binary_ip import ops as binary_ops
        if self.dim is None:
            raise ValueError("OneBitScorer.dim unset — encode_docs first or "
                             "pass dim= at construction")
        return binary_ops.binary_ip_scores_gathered(
            q, gathered, self.dim, offset=self.quantizer.offset)

    def decode(self, storage):
        return self.quantizer.decode(storage, self.dim)


# quantizer class → scorer factory.  Extend with register_scorer().
_SCORER_FOR_QUANTIZER: dict[type, Callable[..., Scorer]] = {}
_SCORER_BY_NAME: dict[str, Callable[..., Scorer]] = {}


def register_scorer(name: str, quantizer_cls: Optional[type],
                    factory: Callable[..., Scorer]) -> None:
    """Register a scorer backend under ``name`` (and its quantizer class).

    ``factory(quantizer, sim=..., backend=...) → Scorer``; for the plain
    float backend the quantizer argument is None.
    """
    _SCORER_BY_NAME[name] = factory
    if quantizer_cls is not None:
        _SCORER_FOR_QUANTIZER[quantizer_cls] = factory


register_scorer("float", None,
                lambda quantizer=None, **kw: Scorer(**kw))
register_scorer("fp16", FloatCast,
                lambda quantizer=None, **kw: FloatCastScorer(
                    quantizer or FloatCast(), **kw))
register_scorer("int8", Int8Quantizer,
                lambda quantizer=None, **kw: Int8Scorer(
                    quantizer or Int8Quantizer(), **kw))
register_scorer("onebit", OneBitQuantizer,
                lambda quantizer=None, **kw: OneBitScorer(
                    quantizer or OneBitQuantizer(), **kw))


def scorer_names() -> tuple[str, ...]:
    return tuple(_SCORER_BY_NAME)


def backend_tail_stages() -> dict[str, list[Transform]]:
    """Canonical {backend name: trailing pipeline stages} sweep table.

    One place for tests and benchmarks that cover every scorer backend;
    stages are stateful once fitted, so each call returns fresh instances
    (never share them across pipelines).
    """
    return {"float": [], "fp16": [FloatCast()],
            "int8": [Int8Quantizer()], "onebit": [OneBitQuantizer(0.5)]}


def get_scorer(name: str, quantizer: Optional[Transform] = None,
               sim: str = "ip", backend: str = "auto") -> Scorer:
    if name not in _SCORER_BY_NAME:
        raise KeyError(f"unknown scorer {name!r}; have {scorer_names()}")
    return _SCORER_BY_NAME[name](quantizer, sim=sim, backend=backend)


def apply_float_stages(stages, x: torch.Tensor, kind: str) -> torch.Tensor:
    """Run docs/queries through a pipeline's float stages."""
    for t in stages:
        x = t(x, kind)
    return x


def encode_storage(float_stages, scorer: Scorer, docs: torch.Tensor
                   ) -> tuple[torch.Tensor, int]:
    """Docs → (storage rows, width of the float rows) through the frozen
    stages: the doc encode of an index build and of a live add.

    With kernel numerics, the paper's pre+post-normalized 24× recipe
    (``[CenterNorm, PCA, CenterNorm]`` + int8) encodes in one pass through
    ``fused_quantize`` — the same function as the staged pair below, whose
    rows do not depend on the batch on the card.  Anything else runs the
    float stages, then the scorer's encode.
    """
    if isinstance(scorer, Int8Scorer) and scorer.use_kernel(docs):
        from repro_torch.kernels.fused_quantize import ops as fq_ops
        stages = [*float_stages, scorer.quantizer]
        if fq_ops.fusable(stages):
            codes = fq_ops.fused_quantize(docs, stages, "docs",
                                          use_kernel=True)
            return codes, int(codes.shape[-1])
    x = apply_float_stages(float_stages, docs, "docs")
    return scorer.encode_docs(x), int(x.shape[-1])


def _factory_for(quantizer: Transform) -> Optional[Callable[..., Scorer]]:
    factory = _SCORER_FOR_QUANTIZER.get(type(quantizer))
    if factory is not None:
        return factory
    for cls, factory in _SCORER_FOR_QUANTIZER.items():
        if isinstance(quantizer, cls):
            return factory
    return None


def split_pipeline(pipeline: CompressionPipeline
                   ) -> tuple[list[Transform], Optional[Transform]]:
    """Split transforms into (float stages, trailing quantizer|None)."""
    stages = list(pipeline.transforms)
    if stages and _factory_for(stages[-1]) is not None:
        return stages[:-1], stages[-1]
    return stages, None


def scorer_for_pipeline(pipeline: CompressionPipeline, sim: str = "ip",
                        backend: str = "auto"
                        ) -> tuple[list[Transform], Scorer]:
    """(float stages, scorer) for a pipeline's storage representation."""
    float_stages, quantizer = split_pipeline(pipeline)
    if quantizer is None:
        return float_stages, Scorer(sim=sim, backend=backend)
    return float_stages, _factory_for(quantizer)(quantizer, sim=sim,
                                                 backend=backend)
