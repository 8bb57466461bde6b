"""Hand-written CUDA C++ kernels for Hopper (``sm_90a``), one per TPU kernel.

Each subpackage holds ``kernel.py`` (the wrapper: checks its inputs,
launches the kernel for CUDA tensors, counts its launches in the counter
``<wrapper>.launches`` of :mod:`repro_torch.tracing`, and runs the plain
version for CPU tensors only), ``ref.py`` (the plain PyTorch version of
the same function) and ``ops.py`` (the public op, as in
``repro.kernels``).  The CUDA sources live in ``repro_torch/csrc/`` and
are built by :mod:`repro_torch.kernels._build` at first use.

- ``int8_ip``     : int8 index scoring, bf16(q⊙scale) × u8 with f32 sums on
                    the tensor cores, + a per-query bias (q·zero).
- ``binary_ip``   : 1-bit index scoring, the sign dot on the tensor cores
                    (s8 × 0/1 bits), written as the f32 score 0.25·dot.
- ``topk_blocks`` : per-block top-k, stage 1 of the exact two-stage top-k,
                    one pass over each block whatever k is; beside it
                    ``topk_merge``, stage 2, which merges the blocks'
                    sorted lists (it replaces ``lax.top_k``, not a Pallas
                    kernel, so it is not among ``WRAPPERS``; its counter
                    is ``topk_merge.launches``).
- ``ivf_fused``   : IVF search, list-major: the probe table inverted, each
                    probed list scored once for its (query, slot) pairs,
                    each query's candidates merged (wrapper
                    ``fused_ivf_topk``).
- ``fused_quantize``: the one-pass doc encode of the pre+post-normalized
                    24× recipe (center+normalize, PCA, center+normalize,
                    int8).
"""

from repro_torch import tracing

#: the kernel wrappers, by name
WRAPPERS = ("int8_ip", "binary_ip", "topk_blocks", "fused_ivf_topk",
            "fused_quantize")


def launch_counts() -> dict[str, int]:
    """{kernel wrapper name: launches so far} for every kernel wrapper."""
    counts = tracing.counters()
    return {name: counts.get(name + ".launches", 0) for name in WRAPPERS}


def reset_launch_counts() -> None:
    tracing.reset([name + ".launches" for name in WRAPPERS])
