"""The share of the traced window in which no operation ran on the
device (moves ``qps.ivf``)."""

from portbench.harness.readers import idle_percent as read  # noqa: F401
