"""Query rows a micro-batch carried: the differences of the serving
engine's ``queries_served`` and ``batches_served`` counters between the
window's ends (moves ``p95_ms``)."""


def read(ctx):
    b = ctx.counters.get("batches_served", 0)
    return ctx.counters["queries_served"] / b if b else None
