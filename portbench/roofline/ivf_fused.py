"""``fused_ivf_topk`` (``csrc/ivf_fused.cu``: invert count / scan /
scatter, ``ivf_score_lists``, ``ivf_merge_candidates``): each probed
list scored once for the (query, slot) pairs that probe it, each query's
candidates merged to its top k.

A call of Q queries at ``nprobe`` needs the rows and 4-byte ids of every
distinct probed list once (``list_rows`` rows of ``row_bytes``), the
encoded queries, the probe table and its per-pair base (8 bytes a pair),
and the (Q, k) values and ids written once.  Operations: 2·d for each
valid (query, row) pair (``pairs``), d the rows' logical width; the
1-bit sign dot at the int8 rate, int8 rows at the bf16 rate."""


def work(q: int, nprobe: int, k: int, pairs: int, list_rows: int,
         row_bytes: int, q_bytes: int, d: int, onebit: bool
         ) -> tuple[float, float, str]:
    n_bytes = (list_rows * (row_bytes + 4) + q * q_bytes + q * nprobe * 8
               + q * k * 8)
    return float(n_bytes), 2.0 * pairs * d, ("int8" if onebit else "bf16")
