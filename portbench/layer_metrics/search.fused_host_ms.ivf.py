"""The host's time a batch in the fused IVF top-k call (the queries
prepared, the base, the five launches): the self time of the program's
``search.ivf_fused`` span inside each ``search`` call, median over the
traced window's batches (moves ``qps.ivf``)."""

from portbench.harness.program_spans import median_ms


def read(ctx):
    return median_ms("search.ivf_fused", "host")
