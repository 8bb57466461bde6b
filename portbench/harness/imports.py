"""What the benchmark's process must not hold: JAX, and the JAX package
beside the port, or its benchmarks.  Names are compared by their top-level
part whole, so ``repro_torch`` is not taken for ``repro``."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")


def top_level(names) -> set:
    return {str(n).split(".", 1)[0] for n in names}


def forbidden_loaded(modules=None) -> list:
    """The forbidden top-level names among ``modules`` (default: the
    process's ``sys.modules``)."""
    names = sys.modules if modules is None else modules
    return sorted(top_level(names) & set(FORBIDDEN))
