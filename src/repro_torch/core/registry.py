"""Named factory for the paper's compression configurations.

Counterpart of ``repro.core.registry`` for the rows on the port's path so
far.  ``build_method(name, dim=..)`` returns a ready-to-fit
:class:`~repro_torch.core.pipeline.CompressionPipeline`; the transform
registry rebuilds pipelines from the ``(class name, init_config())``
descriptors that index artifacts record.  A name ``repro`` knows but the
port does not have yet raises ``NotImplementedError`` naming the later
slice of the port it waits for.
"""

from __future__ import annotations

from typing import Optional

from repro_torch.core.pca import PCA
from repro_torch.core.pipeline import CompressionPipeline
from repro_torch.core.preprocess import (Center, CenterNorm, Normalize,
                                         Transform, ZScore)
from repro_torch.core.quantization import (FloatCast, Int8Quantizer,
                                           OneBitQuantizer)
from repro_torch.core.rotation import LearnedRotation

METHODS = (
    "original", "pca", "pca_scaled",
    "fp16", "int8", "onebit", "onebit_offset0",
    "pca_int8", "pca_onebit", "pca_rot_onebit",
)

_OFF_PATH_SLICE = "slice 6 of the port (off-path transforms)"

#: names ``repro`` has and the port does not yet → the slice that adds them
_LATER_METHODS = {m: _OFF_PATH_SLICE for m in (
    "gaussian_projection", "sparse_projection", "dim_drop",
    "greedy_dim_drop", "ae_linear", "ae_full", "ae_shallow",
    "ae_linear_l1", "ae_full_l1", "ae_shallow_l1",
    "distance_learning", "contrastive")}
_LATER_TRANSFORMS = {t: _OFF_PATH_SLICE for t in (
    "DimensionDrop", "GreedyDimensionDrop", "GaussianProjection",
    "SparseProjection", "Autoencoder", "SimilarityPreservingProjection",
    "ContrastiveProjection")}


def _core_stages(name: str, dim: int) -> list[Transform]:
    table = {
        "original": lambda: [],
        "pca": lambda: [PCA(dim)],
        "pca_scaled": lambda: [PCA(dim, scale_components="paper")],
        "fp16": lambda: [FloatCast("float16")],
        "int8": lambda: [Int8Quantizer()],
        "onebit": lambda: [OneBitQuantizer(offset=0.5)],
        "onebit_offset0": lambda: [OneBitQuantizer(offset=0.0)],
        # paper: PCA(245) + 1-bit = 100× compression
        "pca_onebit": lambda: [PCA(dim), OneBitQuantizer(offset=0.5)],
        # paper: PCA(128) + int8 = 24× compression
        "pca_int8": lambda: [PCA(dim), Int8Quantizer()],
        # the same 100× storage as pca_onebit; an orthogonal rotation
        # re-aims the sign grid after PCA (free at search time)
        "pca_rot_onebit": lambda: [PCA(dim), LearnedRotation(),
                                   OneBitQuantizer(offset=0.5)],
    }
    if name in table:
        return table[name]()
    if name in _LATER_METHODS:
        raise NotImplementedError(
            f"compression method {name!r} is not ported yet: it waits for "
            f"{_LATER_METHODS[name]}")
    raise ValueError(f"unknown compression method {name!r}; "
                     f"known: {METHODS}")


def build_method(name: str, dim: int = 128, *, pre: bool = True,
                 post: bool = True) -> CompressionPipeline:
    """Build a pipeline for a named Table-2 row.

    ``pre``/``post`` toggle the center+normalize wrapping.  ``post=True``
    lands after a trailing quantizer and makes the storage float; pass
    ``post=False`` to keep quantized storage on the kernel path.
    """
    stages: list[Transform] = [CenterNorm()] if pre else []
    core = _core_stages(name, dim)
    stages.extend(core)
    if post and core:
        stages.append(CenterNorm())
    return CompressionPipeline(stages)


def method_compression_ratio(name: str, dim: int,
                             input_dim: int = 768) -> float:
    pipe = build_method(name, dim, pre=False, post=False)
    return pipe.compression_ratio(input_dim)


#: class name → class, for every pipeline stage the port ships; artifacts
#: record each stage as ``(type name, init_config())``.
TRANSFORMS: dict[str, type] = {}


def register_transform(cls: type) -> type:
    """Register a :class:`Transform` subclass for declarative rebuild."""
    TRANSFORMS[cls.__name__] = cls
    return cls


for _cls in (Center, CenterNorm, Normalize, ZScore, PCA, LearnedRotation,
             FloatCast, Int8Quantizer, OneBitQuantizer):
    register_transform(_cls)


def transform_spec(t: Transform) -> tuple[str, dict]:
    """``(type name, constructor kwargs)`` descriptor for one stage."""
    return type(t).__name__, t.init_config()


def build_transform(name: str, config: Optional[dict] = None) -> Transform:
    """Rebuild an (unfitted) transform from its :func:`transform_spec`."""
    if name in TRANSFORMS:
        return TRANSFORMS[name](**(config or {}))
    if name in _LATER_TRANSFORMS:
        raise NotImplementedError(
            f"transform {name!r} is not ported yet: it waits for "
            f"{_LATER_TRANSFORMS[name]}")
    raise KeyError(f"unknown transform {name!r}; registered: "
                   f"{sorted(TRANSFORMS)} — register_transform() custom "
                   "stages before loading artifacts that use them")


def pipeline_spec(pipeline: CompressionPipeline) -> list[tuple[str, dict]]:
    """Stage descriptors for a whole pipeline (see :func:`transform_spec`)."""
    return [transform_spec(t) for t in pipeline.transforms]


def build_pipeline_from_spec(stages) -> CompressionPipeline:
    """Rebuild an unfitted pipeline from :func:`pipeline_spec` output."""
    return CompressionPipeline(
        [build_transform(name, dict(cfg)) for name, cfg in stages])
