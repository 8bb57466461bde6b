"""The program's own spans and counters (``repro_torch.tracing``), as the
per-layer readers see them.

The program records its spans while a profiler records, so a ``--trace
1`` run holds the traced window's spans.  A span's record gives its name,
its parent span, its host start and end (ns) and, on the card, the device
time between its ends (ms).  A program without ``repro_torch.tracing``
has none of this, and every function here then gives ``None``.
"""

from __future__ import annotations

from typing import Optional

from portbench.harness.stats import percentile

#: the span around one call of an index's ``search``
ROOT = "search"


def _tracing():
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    return tracing


def program_records() -> Optional[list]:
    t = _tracing()
    return None if t is None else t.records()


def program_counters() -> Optional[dict]:
    t = _tracing()
    return None if t is None else t.counters()


def host_ms(rec: dict) -> float:
    return (rec["end_ns"] - rec["start_ns"]) * 1e-6


def self_host_ms(records: list) -> dict:
    """{id: host ms of the span less the host ms of its child spans}."""
    own = {r["id"]: host_ms(r) for r in records if r["end_ns"] is not None}
    out = dict(own)
    for r in records:
        if r["parent"] in out and r["id"] in own:
            out[r["parent"]] -= own[r["id"]]
    return out


def per_root(records: list, name: str, clock: str) -> Optional[list]:
    """For each root ``search`` span, the sum over its descendants named
    ``name`` of their host self ms (``clock="host"``) or device ms
    (``clock="device"``); ``None`` where no root holds such a span."""
    by_id = {r["id"]: r for r in records}
    roots = {r["id"]: 0.0 for r in records
             if r["name"] == ROOT and r["parent"] is None
             and r["end_ns"] is not None}
    own = self_host_ms(records) if clock == "host" else None
    found = False
    for r in records:
        if r["name"] != name:
            continue
        value = own.get(r["id"]) if clock == "host" else r["device_ms"]
        if value is None:
            continue
        up = by_id.get(r["parent"])
        while up is not None and up["id"] not in roots:
            up = by_id.get(up["parent"])
        if up is not None:
            roots[up["id"]] += value
            found = True
    return list(roots.values()) if found else None


def median_ms(name: str, clock: str,
              records: Optional[list] = None) -> Optional[float]:
    """The median over the traced window's root ``search`` spans of
    :func:`per_root`; ``None`` where the program records no such span."""
    if records is None:
        records = program_records()
    if not records:
        return None
    values = per_root(records, name, clock)
    return percentile(values, 50) if values else None


def ratio(numerator: str, denominator: str,
          counters: Optional[dict] = None) -> Optional[float]:
    """One program counter over another; ``None`` where either is absent
    or the denominator is 0."""
    if counters is None:
        counters = program_counters()
    if not counters or not counters.get(denominator) or \
            numerator not in counters:
        return None
    return counters[numerator] / counters[denominator]
