"""The share of the traced window in which no operation ran on the
device, for an open-loop serving cell (moves ``p95_ms``)."""

from portbench.harness.readers import idle_percent as read  # noqa: F401
