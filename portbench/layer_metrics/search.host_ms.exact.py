"""The host's time inside ``search`` a batch, from the call to its return
before the results are copied (the enqueue cost), median over the
window's batches (moves ``qps.exact``)."""

from portbench.harness.readers import search_host_ms as read  # noqa: F401
