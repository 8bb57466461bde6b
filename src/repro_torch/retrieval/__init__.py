"""Dense retrieval substrate in PyTorch: exact and IVF top-k, metrics,
artifacts.

The declarative front door is :mod:`repro_torch.retrieval.api`::

    spec = IndexSpec(method="pca_int8", dim=128, post=False)
    index = build_index(spec, docs, queries_sample)       # on CUDA
    index.save("kb.npz");  index = load_index("kb.npz")

``IndexSpec(..., mutable=True)`` builds a :class:`SegmentedIndex`: live
``add``/``delete``, ``compact()``, saved as a version-2 artifact.
``IndexSpec(..., shard=ShardSpec(shards=4))`` builds a
:class:`ShardedCompressedIndex` (or :class:`ShardedIVFIndex` with ``ivf``)
over the mesh the spec describes.
"""

from repro_torch.retrieval.api import (Index, IndexSpec, ShardSpec,
                                       build_index, load_index,
                                       load_index_meta, save_index)
from repro_torch.retrieval.index import CompressedIndex, DenseIndex
from repro_torch.retrieval.ivf import IVFFlatIndex, IVFIndex
from repro_torch.retrieval.rprecision import (make_dim_drop_scorer,
                                              r_precision,
                                              r_precision_from_ids,
                                              recall_at_k,
                                              retrieved_relevant_counts)
from repro_torch.retrieval.segments import DriftMonitor, SegmentedIndex
from repro_torch.retrieval.sharded import (ShardedCompressedIndex,
                                           ShardedIVFIndex,
                                           partition_ivf_lists)
from repro_torch.retrieval.scorers import (Scorer, backend_tail_stages,
                                           get_scorer, register_scorer,
                                           scorer_for_pipeline, scorer_names)
from repro_torch.retrieval.topk import (masked_topk_by_id, resolve_k,
                                        topk_score_then_id, topk_search)

__all__ = [
    "Index", "IndexSpec", "ShardSpec", "build_index", "load_index",
    "load_index_meta", "save_index",
    "CompressedIndex", "DenseIndex", "IVFFlatIndex", "IVFIndex",
    "DriftMonitor", "SegmentedIndex",
    "ShardedCompressedIndex", "ShardedIVFIndex", "partition_ivf_lists",
    "Scorer", "backend_tail_stages", "get_scorer", "register_scorer",
    "scorer_for_pipeline", "scorer_names",
    "make_dim_drop_scorer", "r_precision", "r_precision_from_ids",
    "recall_at_k",
    "retrieved_relevant_counts",
    "masked_topk_by_id", "resolve_k", "topk_score_then_id", "topk_search",
]
