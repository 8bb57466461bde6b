"""How late the load generator sent: the 95th percentile, over every
request of the window, of its send time past its scheduled time (moves
``p95_ms``)."""

from portbench.harness.stats import percentile


def read(ctx):
    return percentile(ctx.send_lags, 95) * 1e3 if ctx.send_lags else None
