"""The share in % of stage-1 tiles of the exact top-k ((row, block) of
``topk_blocks``) that took the kernel's slow tie path: the program's
device counter ``topk_blocks.tie_tiles`` over its host counter
``topk_blocks.tiles``.  The counters run all through the run; the bulk
mix has one shape, so the ratio is the window's (moves ``qps.exact``)."""

from portbench.harness.program_spans import ratio


def read(ctx):
    r = ratio("topk_blocks.tie_tiles", "topk_blocks.tiles")
    return None if r is None else 100.0 * r
