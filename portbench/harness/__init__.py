"""The harness: cells by name, the traffic generator, tracing, the readers'
context and the comparison that decides ``correct``."""
