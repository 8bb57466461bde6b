"""paper-dpr — the paper's own experimental setting as a config:
768-dim DPR-CLS-like KB (HotpotQA-scale pruned: 2.1M docs), compressed with
the Table-2 pipelines, served via the sharded retrieval engine."""

import dataclasses

from repro_torch.configs.base import ArchConfig, ShapeSpec


@dataclasses.dataclass(frozen=True)
class DPRIndexConfig:
    name: str = "paper-dpr"
    dim: int = 768
    pca_dim: int = 128
    pca_dim_100x: int = 245      # PCA(245)+1bit = 100× (paper Table 2)
    n_docs: int = 2_100_000      # HotpotQA pruned
    n_queries: int = 6_000
    storage: str = "int8"        # fp32 (paper-faithful exact) | int8 | onebit
    # naive: materialize (Q, D_local) scores, lax.top_k over the sharded
    # axis (baseline).  two_stage: doc-chunked scan + running local top-k,
    # then a k-sized cross-shard merge (the topk_blocks kernel schedule).
    topk_impl: str = "two_stage"
    query_chunk: int = 512
    doc_chunk: int = 131072


FULL = DPRIndexConfig()
REDUCED = DPRIndexConfig(name="paper-dpr-smoke", n_docs=20_000,
                         n_queries=400)

SHAPES = (
    ShapeSpec("search_exact", "kb_search",
              {"n_docs": 2_100_000, "n_queries": 6000, "k": 16}),
    ShapeSpec("search_50m", "kb_search",
              {"n_docs": 49_700_000, "n_queries": 6000, "k": 16},
              note="unpruned KILT-scale index (dry-run only)"),
)

ARCH = ArchConfig(name="paper-dpr", family="retrieval", model=FULL,
                  shapes=SHAPES, reduced=REDUCED)
