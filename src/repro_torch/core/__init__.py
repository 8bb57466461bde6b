"""The paper's contribution: post-hoc KB index compression, in PyTorch."""

from repro_torch.core.autoencoder import (PAPER_L1, Autoencoder,
                                          AutoencoderConfig)
from repro_torch.core.distance_learning import (
    ContrastiveProjection, SimilarityPreservingProjection)
from repro_torch.core.pca import PCA, moments
from repro_torch.core.pipeline import CompressionPipeline
from repro_torch.core.preprocess import (Center, CenterNorm, Normalize,
                                         PreprocessSpec, Transform, ZScore)
from repro_torch.core.quantization import (FloatCast, Int8Quantizer,
                                           OneBitQuantizer, compression_ratio,
                                           pack_bits, unpack_bits)
from repro_torch.core.random_projection import (DimensionDrop,
                                                GaussianProjection,
                                                GreedyDimensionDrop,
                                                SparseProjection)
from repro_torch.core.registry import (METHODS, TRANSFORMS, build_method,
                                       build_pipeline_from_spec,
                                       build_transform,
                                       method_compression_ratio,
                                       pipeline_spec, register_transform,
                                       transform_spec)
from repro_torch.core.rotation import LearnedRotation

__all__ = [
    "Autoencoder", "AutoencoderConfig", "PAPER_L1",
    "ContrastiveProjection", "SimilarityPreservingProjection",
    "PCA", "moments", "CompressionPipeline", "LearnedRotation",
    "Center", "CenterNorm", "Normalize", "PreprocessSpec", "Transform",
    "ZScore",
    "FloatCast", "Int8Quantizer", "OneBitQuantizer", "compression_ratio",
    "pack_bits", "unpack_bits",
    "DimensionDrop", "GaussianProjection", "GreedyDimensionDrop",
    "SparseProjection",
    "METHODS", "build_method", "method_compression_ratio",
    "TRANSFORMS", "build_pipeline_from_spec", "build_transform",
    "pipeline_spec", "register_transform", "transform_spec",
]
