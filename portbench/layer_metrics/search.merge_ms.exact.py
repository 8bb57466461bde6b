"""Stage 2 of the exact top-k (the stable sorts that rank the blocks'
candidates) on the device a batch: the program's ``search.topk.merge``
span inside each ``search`` call, timed by its CUDA events, median over
the traced window's batches (moves ``qps.exact``)."""

from portbench.harness.program_spans import median_ms


def read(ctx):
    return median_ms("search.topk.merge", "device")
