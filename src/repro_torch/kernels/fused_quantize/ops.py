"""Public op: the one-pass doc encode of the paper's pre+post-normalized
24× recipe, ``[CenterNorm, PCA, CenterNorm, Int8Quantizer]``.

Counterpart of ``repro.kernels.fused_quantize.ops``.  The pipeline's
fitted state folds into (μ₁, W, μ₂′, scale, zero): PCA subtracts its mean
after the first normalize, so ``(y − m) @ W = y @ W − m @ W`` and the
mean moves into μ₂′ = μ₂ + m @ W.
"""

from __future__ import annotations

from repro_torch.core.pca import PCA
from repro_torch.core.preprocess import CenterNorm
from repro_torch.core.quantization import Int8Quantizer
from repro_torch.kernels.fused_quantize import kernel as _kernel
from repro_torch.kernels.fused_quantize import ref as _ref


def fusable(stages) -> bool:
    """Is this stage list ``[CenterNorm, PCA, CenterNorm, Int8Quantizer]``?"""
    stages = list(stages)
    return (len(stages) == 4 and isinstance(stages[0], CenterNorm)
            and isinstance(stages[1], PCA)
            and isinstance(stages[2], CenterNorm)
            and isinstance(stages[3], Int8Quantizer))


def params_from_pipeline(pipeline, kind: str = "docs"):
    """(μ₁, W, μ₂′, scale, zero) of a fitted ``[CenterNorm, PCA,
    CenterNorm, Int8Quantizer]`` pipeline (or its list of stages)."""
    stages = list(getattr(pipeline, "transforms", pipeline))
    if not fusable(stages):
        raise ValueError(
            "fused_quantize expects [CenterNorm, PCA, CenterNorm, Int8]; got "
            f"[{', '.join(type(t).__name__ for t in stages)}]")
    sfx = "queries" if kind == "queries" else "docs"
    pca = stages[1]
    w = pca.projection_matrix()
    mu1 = stages[0].state[f"mean_{sfx}"]
    mu2 = stages[2].state[f"mean_{sfx}"] + pca.state["mean"] @ w
    return mu1, w, mu2, stages[3].state["scale"], stages[3].state["zero"]


def fused_quantize(x, pipeline, kind: str = "docs",
                   use_kernel: bool = False):
    """Encode (N, d) float vectors → (N, d′) uint8 in one pass.

    ``use_kernel`` runs the kernel wrapper (the Hopper kernel on a CUDA
    tensor, its plain version on a CPU tensor); otherwise the plain
    version runs directly.
    """
    mu1, w, mu2, scale, zero = params_from_pipeline(pipeline, kind)
    if use_kernel:
        return _kernel.fused_quantize(x, mu1, w, mu2, scale, zero)
    return _ref.fused_quantize_ref(x, mu1, w, mu2, scale, zero)
