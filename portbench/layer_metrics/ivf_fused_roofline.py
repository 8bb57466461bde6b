"""``fused_ivf_topk``'s share of its roofline: the sum of its five
sub-kernels' device time over the traced window's search calls (moves
``qps``)."""

from portbench.harness.readers import roofline_share
from portbench.roofline import ivf_fused

KERNELS = ["ivf_invert_count", "ivf_invert_scan", "ivf_invert_scatter",
           "ivf_score_lists", "ivf_merge_candidates"]


def read(ctx):
    f = ctx.facts
    if not ctx.config.get("ivf"):
        return None
    onebit = f["scorer"] == "onebit"
    q_bytes = f["row_bytes"] * 8 if onebit else f["code_dim"] * 2
    return roofline_share(
        ctx, KERNELS,
        lambda c: ivf_fused.work(c["n"], c["nprobe"], c["k"], c["pairs"],
                                 c["list_rows"], f["row_bytes"], q_bytes,
                                 f["code_dim"], onebit))
