"""``topk_blocks``'s share of its roofline over the traced window's search
calls (moves ``qps``): both of the kernel file's entry kernels."""

from portbench.harness.readers import roofline_share
from portbench.roofline import topk_blocks


def read(ctx):
    if ctx.config.get("ivf"):
        return None
    return roofline_share(
        ctx, ["topk_blocks_kernel", "topk_warp_kernel"],
        lambda c: topk_blocks.work(c["n"], ctx.facts["n_docs"], c["k"]))
