"""What the per-layer readers share: the reading context and the
arithmetic of a kernel's roofline share."""

from __future__ import annotations

import dataclasses
import re
from typing import Optional

from portbench.harness.stats import percentile
from portbench.roofline import peaks


@dataclasses.dataclass
class Context:
    """One traced run, as the readers see it."""
    config: dict
    trace: Optional[dict]     # Tracer.reduce(): kernels, busy_s, window_s, launches
    calls: list               # the traced window's search calls and their work
    facts: dict               # index sizes (rows, row bytes, lists)
    rates: dict               # the card's peaks (roofline.peaks.rates)
    spans: dict               # harness spans: name → host seconds each
    counters: dict            # program counters' deltas over the window
    send_lags: list           # seconds each request was sent late
    setup: dict               # set-up times by part


def kernel_seconds(ctx: Context, names) -> float:
    """Device seconds of the traced kernels whose name holds one of
    ``names`` as a word."""
    if ctx.trace is None:
        return 0.0
    pat = re.compile(r"\b(" + "|".join(map(re.escape, names)) + r")\b")
    return sum(sec for name, (sec, _) in ctx.trace["kernels"].items()
               if pat.search(name))


def roofline_share(ctx: Context, names, work) -> Optional[float]:
    """100 × (the least time the traced calls could take) / (their kernels'
    device time), where ``work(call)`` gives a call's (bytes, operations,
    rate name), or ``None`` for a call that does not run the kernel;
    nothing where the trace holds neither."""
    t = kernel_seconds(ctx, names)
    bound = 0.0
    for call in ctx.calls:
        w = work(call)
        if w is not None:
            n_bytes, n_ops, rate = w
            bound += peaks.bound_s(n_bytes, n_ops, ctx.rates[rate],
                                   ctx.rates["bytes"])[0]
    if t <= 0.0 or bound <= 0.0:
        return None
    return 100.0 * bound / t


def idle_percent(ctx: Context) -> Optional[float]:
    """100 × the traced window's share with no device operation."""
    if ctx.trace is None or ctx.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace["busy_s"] / ctx.trace["window_s"])


def search_host_ms(ctx: Context) -> Optional[float]:
    s = ctx.spans.get("search.host")
    return percentile(s, 50) * 1e3 if s else None


def batch_p95_ms(ctx: Context) -> Optional[float]:
    s = ctx.spans.get("bulk.batch")
    return percentile(s, 95) * 1e3 if s else None
