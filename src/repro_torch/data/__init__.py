"""Deterministic synthetic corpora."""

from repro_torch.data.synthetic import (DPRPopulation, KBData,
                                        dpr_like_population,
                                        draw_dpr_like_docs,
                                        draw_dpr_like_queries,
                                        make_dpr_like_kb)

__all__ = ["DPRPopulation", "KBData", "dpr_like_population",
           "draw_dpr_like_docs", "draw_dpr_like_queries", "make_dpr_like_kb"]
