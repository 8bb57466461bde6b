"""Named factory for every compression configuration in the paper.

Counterpart of ``repro.core.registry``.  ``build_method(name, dim=..)``
returns a ready-to-fit :class:`~repro_torch.core.pipeline.
CompressionPipeline`; names mirror the rows of paper Table 2.  The
transform registry rebuilds pipelines from the ``(class name,
init_config())`` descriptors that index artifacts record.
"""

from __future__ import annotations

from typing import Optional

from repro_torch.core.autoencoder import (PAPER_L1, Autoencoder,
                                          AutoencoderConfig)
from repro_torch.core.distance_learning import (
    ContrastiveProjection, SimilarityPreservingProjection)
from repro_torch.core.pca import PCA
from repro_torch.core.pipeline import CompressionPipeline
from repro_torch.core.preprocess import (Center, CenterNorm, Normalize,
                                         Transform, ZScore)
from repro_torch.core.quantization import (FloatCast, Int8Quantizer,
                                           OneBitQuantizer)
from repro_torch.core.random_projection import (DimensionDrop,
                                                GaussianProjection,
                                                GreedyDimensionDrop,
                                                SparseProjection)
from repro_torch.core.rotation import LearnedRotation

METHODS = (
    "original",
    "gaussian_projection", "sparse_projection",
    "dim_drop", "greedy_dim_drop",
    "pca", "pca_scaled",
    "ae_linear", "ae_full", "ae_shallow",
    "ae_linear_l1", "ae_full_l1", "ae_shallow_l1",
    "fp16", "int8", "onebit", "onebit_offset0",
    "pca_onebit", "pca_int8", "pca_rot_onebit",
    "distance_learning", "contrastive",
)

_AE_VARIANTS = {"ae_linear": "linear", "ae_full": "full",
                "ae_shallow": "shallow_decoder"}


def _core_stages(name: str, dim: int, *, greedy_scorer=None,
                 ae_epochs: int = 5) -> list[Transform]:
    if name.startswith("ae_") and name.replace("_l1", "") in _AE_VARIANTS:
        l1 = PAPER_L1 if name.endswith("_l1") else 0.0
        return [Autoencoder(AutoencoderConfig(
            variant=_AE_VARIANTS[name.replace("_l1", "")], bottleneck=dim,
            l1=l1, epochs=ae_epochs))]
    table = {
        "original": lambda: [],
        "gaussian_projection": lambda: [GaussianProjection(dim)],
        "sparse_projection": lambda: [SparseProjection(dim)],
        "dim_drop": lambda: [DimensionDrop(dim)],
        "greedy_dim_drop": lambda: [GreedyDimensionDrop(
            dim, scorer=greedy_scorer)],
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
        "distance_learning": lambda: [SimilarityPreservingProjection(
            dim=dim)],
        "contrastive": lambda: [ContrastiveProjection(dim=dim)],
    }
    if name not in table:
        raise ValueError(f"unknown compression method {name!r}; "
                         f"known: {METHODS}")
    return table[name]()


def build_method(name: str, dim: int = 128, *, pre: bool = True,
                 post: bool = True, greedy_scorer=None,
                 ae_epochs: int = 5) -> CompressionPipeline:
    """Build a pipeline for a named Table-2 row.

    ``pre``/``post`` toggle the center+normalize wrapping.  ``post=True``
    lands after a trailing quantizer and makes the storage float; pass
    ``post=False`` to keep quantized storage on the kernel path.
    ``greedy_scorer`` is ``greedy_dim_drop``'s scorer (see
    :func:`repro_torch.retrieval.rprecision.make_dim_drop_scorer`);
    ``ae_epochs`` the autoencoders' epochs.
    """
    stages: list[Transform] = [CenterNorm()] if pre else []
    core = _core_stages(name, dim, greedy_scorer=greedy_scorer,
                        ae_epochs=ae_epochs)
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


for _cls in (Center, CenterNorm, Normalize, ZScore, PCA, FloatCast,
             Int8Quantizer, OneBitQuantizer, DimensionDrop,
             GreedyDimensionDrop, GaussianProjection, SparseProjection,
             Autoencoder, SimilarityPreservingProjection,
             ContrastiveProjection, LearnedRotation):
    register_transform(_cls)


def transform_spec(t: Transform) -> tuple[str, dict]:
    """``(type name, constructor kwargs)`` descriptor for one stage."""
    return type(t).__name__, t.init_config()


def build_transform(name: str, config: Optional[dict] = None) -> Transform:
    """Rebuild an (unfitted) transform from its :func:`transform_spec`."""
    if name not in TRANSFORMS:
        raise KeyError(f"unknown transform {name!r}; registered: "
                       f"{sorted(TRANSFORMS)} — register_transform() custom "
                       "stages before loading artifacts that use them")
    return TRANSFORMS[name](**(config or {}))


def pipeline_spec(pipeline: CompressionPipeline) -> list[tuple[str, dict]]:
    """Stage descriptors for a whole pipeline (see :func:`transform_spec`)."""
    return [transform_spec(t) for t in pipeline.transforms]


def build_pipeline_from_spec(stages) -> CompressionPipeline:
    """Rebuild an unfitted pipeline from :func:`pipeline_spec` output."""
    return CompressionPipeline(
        [build_transform(name, dict(cfg)) for name, cfg in stages])
