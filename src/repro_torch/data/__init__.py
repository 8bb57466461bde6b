"""Deterministic synthetic corpora."""

from repro_torch.data.synthetic import KBData, make_dpr_like_kb

__all__ = ["KBData", "make_dpr_like_kb"]
