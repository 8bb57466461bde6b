"""Tail and spread arithmetic, over every sample of a window."""

from __future__ import annotations

import math
import statistics

import numpy as np


def percentile(values, p: float) -> float:
    """The ``p``-th percentile of every value (linear between order
    statistics, numpy's default); a failed request enters as +inf, so a
    tail past the share that failed is infinite."""
    a = np.asarray(values, dtype=np.float64)
    if a.size == 0:
        return math.nan
    with np.errstate(invalid="ignore"):
        r = float(np.percentile(a, p))
    # between two infinite order statistics numpy gives nan (inf − inf)
    return math.inf if math.isnan(r) and np.isinf(a).any() else r


def spread(values) -> float:
    """Interquartile distance as a share of the median, by
    ``statistics.quantiles(values, n=4)``."""
    q1, q2, q3 = statistics.quantiles(list(values), n=4)
    return (q3 - q1) / q2
