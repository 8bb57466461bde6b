"""Spans and counters inside the port, for a traced window.

``span(name, device)`` marks a stretch of host code.  Recording is on
while a ``torch.profiler`` records, or between :func:`enable` and
:func:`disable`; off, a span is one flag check that returns a shared
no-op context.  On, it keeps a record: its name, its parent (the span
open around it on the same thread), its host start and end by
``time.perf_counter_ns``, and, where the caller names a CUDA ``device``,
a pair of timing events on the current stream, whose elapsed time is read
only when the records are read (no synchronise while the spans run).  An
event record costs the host microseconds, so a caller names the device
only where the device's time is read.  While a profiler
records, the span also opens a CPU op named ``repro_torch.<name>`` on the
profiler's timeline, nested under whatever scope encloses it.  That op is
not a user annotation, so the profiler puts no copy of it on the device's
timeline and it adds nothing to the device's busy time.

``count(name, n)`` is always on: one integer add under a lock.  The kernel wrappers
count their launches through it (``<wrapper>.launches``).

``device_counter(name, device)`` is a counter that lives on the device: a
one-element int64 tensor that a kernel adds to (one ``atomicAdd`` a CTA or
warp that takes the path counted), so a count of what the kernels did
needs no synchronise where it is made.  Only :func:`counters` reads it,
and that read waits for the device.

:func:`records`, :func:`counters` and :func:`reset` read and clear the
store.  At most ``MAX_RECORDS`` records are kept; a span past that is
counted as ``tracing.dropped`` and not recorded.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time

import torch
import torch.autograd.profiler as _autograd_profiler

#: the most records kept between resets
MAX_RECORDS = 1_000_000
#: a span's name on the profiler's timeline is this plus its own
PROFILER_PREFIX = "repro_torch."

_enabled = False
_OFF = contextlib.nullcontext()
_records: list = []
_ids = itertools.count()
_local = threading.local()          # each thread's stack of open spans
_free_events: list = []             # CUDA timing events to reuse
_counters: dict = {}
_counters_lock = threading.Lock()
_device_counters: dict = {}         # (name, device) → int64 tensor of one


class _Record:
    __slots__ = ("id", "parent", "name", "start_ns", "end_ns", "events",
                 "device_ms")

    def __init__(self, parent, name):
        self.id, self.parent, self.name = next(_ids), parent, name
        self.start_ns = self.end_ns = self.device_ms = None
        self.events = None


def _timing_event():
    try:
        return _free_events.pop()
    except IndexError:
        return torch.cuda.Event(enable_timing=True)


class _Span:
    """A recorded span.  Its host interval runs from the first to the last
    instruction of its own ``__enter__`` and ``__exit__``, so that what
    recording costs is counted in the span that pays it, and a root span
    reads what a caller's clock around it reads."""

    __slots__ = ("name", "device", "rec", "stream", "op")

    def __init__(self, name: str, device):
        self.name, self.device = name, device

    def __enter__(self):
        start = time.perf_counter_ns()
        self.op = (torch._C._profiler._RecordFunctionFast(
            PROFILER_PREFIX + self.name)
            if _autograd_profiler._is_profiler_enabled else None)
        if self.op is not None:
            self.op.__enter__()
        if len(_records) >= MAX_RECORDS:
            count("tracing.dropped")
            self.rec = None
            return None
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        rec = self.rec = _Record(stack[-1].id if stack else None, self.name)
        _records.append(rec)
        stack.append(rec)
        self.stream = None
        if self.device is not None and \
                torch.device(self.device).type == "cuda":
            self.stream = torch.cuda.current_stream(self.device)
            rec.events = (_timing_event(), _timing_event())
            rec.events[0].record(self.stream)
        rec.start_ns = start
        return None

    def __exit__(self, *exc):
        rec = self.rec
        if rec is not None:
            if rec.events is not None:
                rec.events[1].record(self.stream)
            _local.stack.pop()
        if self.op is not None:
            self.op.__exit__(*exc)
        if rec is not None:
            rec.end_ns = time.perf_counter_ns()
        return False


def span(name: str, device=None):
    """A context manager marking ``name``; records only while recording
    is on (see the module's docstring).  ``device`` (a ``torch.device``
    or its name) adds the device's time between the span's ends, measured
    by timing events on its current stream, where it is a CUDA device."""
    if not (_enabled or _autograd_profiler._is_profiler_enabled):
        return _OFF
    return _Span(name, device)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``; always on."""
    with _counters_lock:
        _counters[name] = _counters.get(name, 0) + n


def device_counter(name: str, device) -> torch.Tensor:
    """The counter ``name`` on ``device``: a one-element int64 tensor,
    zero when made, for a kernel to add to.  Made on first use; the same
    tensor after that, until :func:`reset` clears it."""
    key = (name, torch.device(device))
    with _counters_lock:
        t = _device_counters.get(key)
        if t is None:
            t = _device_counters[key] = torch.zeros(1, dtype=torch.int64,
                                                    device=key[1])
    return t


def enable() -> None:
    """Record spans whether or not a profiler records."""
    global _enabled
    _enabled = True


def disable() -> None:
    """Record spans only while a profiler records."""
    global _enabled
    _enabled = False


def records() -> list[dict]:
    """The spans recorded since the last :func:`reset`, in the order they
    were entered: ``id``, ``parent`` (an ``id`` or ``None``), ``name``,
    ``start_ns`` and ``end_ns`` (``None`` while the span is open) and
    ``device_ms`` (``None`` without a CUDA device).  Reading waits for the
    device to reach each span's end."""
    out = []
    for rec in list(_records):
        if rec.events is not None and rec.device_ms is None and \
                rec.end_ns is not None:
            rec.events[1].synchronize()
            rec.device_ms = rec.events[0].elapsed_time(rec.events[1])
        out.append({"id": rec.id, "parent": rec.parent, "name": rec.name,
                    "start_ns": rec.start_ns, "end_ns": rec.end_ns,
                    "device_ms": rec.device_ms})
    return out


def counters() -> dict[str, int]:
    """{name: count} of every counter since its last reset, a device
    counter summed over its devices (reading it waits for each device to
    reach it).  A device counter's name is no host counter's."""
    with _counters_lock:
        out = dict(_counters)
        held = list(_device_counters.items())
    device: dict = {}
    for (name, _), t in held:
        device[name] = device.get(name, 0) + int(t.item())
    out.update(device)
    return out


def reset(names=None) -> None:
    """Clear the records and every counter, or, given ``names``, only
    those counters.  A device counter cleared is let go, and the next
    :func:`device_counter` call makes it anew at zero (its memory is
    reused only after the work already queued on its stream)."""
    with _counters_lock:
        for key in [key for key in _device_counters
                    if names is None or key[0] in names]:
            del _device_counters[key]
        if names is not None:
            for name in names:
                _counters.pop(name, None)
            return
        _counters.clear()
    for rec in _records:
        if rec.events is not None:
            _free_events.extend(rec.events)
    _records.clear()
