"""``int8_ip``'s share of its roofline over the traced window's search
calls (moves ``qps``)."""

from portbench.harness.readers import roofline_share
from portbench.roofline import int8_ip


def read(ctx):
    if ctx.facts.get("scorer") != "int8" or ctx.config.get("ivf"):
        return None
    return roofline_share(
        ctx, ["int8_ip_kernel"],
        lambda c: int8_ip.work(c["n"], ctx.facts["n_docs"],
                               ctx.facts["code_dim"]))
