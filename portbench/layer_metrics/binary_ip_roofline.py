"""``binary_ip``'s share of its roofline over the traced window's search
calls, on a flat 1-bit index (moves ``qps``)."""

from portbench.harness.readers import roofline_share
from portbench.roofline import binary_ip


def read(ctx):
    if ctx.facts.get("scorer") != "onebit" or ctx.config.get("ivf"):
        return None
    words = ctx.facts["row_bytes"] // 4
    return roofline_share(
        ctx, ["binary_ip_kernel"],
        lambda c: binary_ip.work(c["n"], ctx.facts["n_docs"], words))
