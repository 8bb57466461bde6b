"""Candidates stage 2 of the exact top-k ranks a query: the program's
``topk.merge_candidates`` counter (query rows × blocks × k into stage 2)
over its ``search.queries`` counter.  The counters run all through the
run; the bulk mix has one shape, so the ratio is the window's (moves
``qps.exact``)."""

from portbench.harness.program_spans import ratio


def read(ctx):
    return ratio("topk.merge_candidates", "search.queries")
