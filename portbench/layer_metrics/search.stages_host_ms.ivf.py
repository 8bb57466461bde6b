"""The host's time a batch in the float stages (the queries encoded up
to the quantizer): the self time of the program's ``search.stages`` span
inside each ``search`` call, median over the traced window's batches
(moves ``qps.ivf``)."""

from portbench.harness.program_spans import median_ms


def read(ctx):
    return median_ms("search.stages", "host")
