"""Survivors at stage 1's bound, in multiples of k: the program's device
counter ``topk_blocks.bound_survivors`` (the elements at or above the
bound of its ring path, 32 < k ≤ 128, summed over the tiles that did not
take the tie path) over those tiles (its host counter
``topk_blocks.tiles`` less the device counter ``topk_blocks.tie_tiles``),
over the traced calls' k.  The counters run all through the run; the
bulk mix has one shape, so the ratio is the window's (moves
``qps.exact``: the fewer survivors, the less the kernel selects and
sorts).  Nothing from a program without the counter."""

from portbench.harness.program_spans import program_counters

SURVIVORS = "topk_blocks.bound_survivors"


def read(ctx):
    counters = program_counters()
    if not counters or SURVIVORS not in counters:
        return None
    tiles = counters.get("topk_blocks.tiles", 0) - \
        counters.get("topk_blocks.tie_tiles", 0)
    ks = {call["k"] for call in (ctx.calls if ctx is not None else [])}
    if tiles <= 0 or len(ks) != 1:
        return None
    return counters[SURVIVORS] / tiles / ks.pop()
