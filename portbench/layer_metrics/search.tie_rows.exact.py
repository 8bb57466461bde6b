"""The share in % of query rows whose stage 2 of the exact top-k
(``topk_merge``) took its exact path, the candidates at or above its
first bound overflowing its buffer: the program's device counter
``topk_merge.tie_rows`` over its ``search.queries`` counter.  The
counters run all through the run; the bulk mix has one shape, so the
ratio is the window's (moves ``qps.exact``)."""

from portbench.harness.program_spans import ratio


def read(ctx):
    r = ratio("topk_merge.tie_rows", "search.queries")
    return None if r is None else 100.0 * r
