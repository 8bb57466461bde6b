"""A batch's whole call, ``search`` and the copy of its ids and scores to
the host, by the host clock: 95th percentile over every batch of the
window (moves ``qps.ivf``)."""

from portbench.harness.readers import batch_p95_ms as read  # noqa: F401
