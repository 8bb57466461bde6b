"""The host's time a batch in the routing (the queries scored against
the centroids, the probed lists chosen): the self time of the program's
``search.route`` span inside each ``search`` call, median over the traced
window's batches (moves ``qps.ivf``)."""

from portbench.harness.program_spans import median_ms


def read(ctx):
    return median_ms("search.route", "host")
