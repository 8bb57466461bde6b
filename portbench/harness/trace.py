"""The traced window: ``torch.profiler`` over CPU and CUDA, the harness's
own spans (``record_function("pb.<name>")``) around its calls into each
layer, and the reduction of the trace to device time by kernel, the
device's busy seconds, and the idle gaps by what the host was in."""

from __future__ import annotations

import contextlib
import re
import time

import torch

#: spans the harness records, as the profiler names them
PREFIX = "pb."


def _short(name: str) -> str:
    """A kernel's name without its return type, namespaces' noise and
    argument list."""
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    return name.split("(", 1)[0][:100]


class Tracer:
    """Off unless ``on``; ``start``/``stop`` bound the traced window once."""

    def __init__(self, on: bool):
        self.on, self.active, self.done = on, False, False
        self.prof = None
        self.t_start = self.t_stop = 0.0
        self.launches0 = self.launches1 = None

    def warm(self) -> None:
        """Start and stop the profiler once in set-up, so that starting it
        in the window costs little."""
        if not self.on:
            return
        with torch.profiler.profile(activities=self._acts()):
            torch.ones(8, device="cuda").sum().item()

    @staticmethod
    def _acts():
        return [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]

    def span(self, name: str):
        if self.active:
            return torch.profiler.record_function(PREFIX + name)
        return contextlib.nullcontext()

    def start(self) -> None:
        if not self.on or self.active or self.done:
            return
        from portbench.harness import program
        self.launches0 = program.launch_counts()
        self.prof = torch.profiler.profile(activities=self._acts())
        self.prof.__enter__()
        self.active = True
        self.t_start = time.perf_counter()

    def stop(self) -> None:
        if not self.active:
            return
        torch.cuda.synchronize()
        self.t_stop = time.perf_counter()
        self.prof.__exit__(None, None, None)
        self.active, self.done = False, True
        from portbench.harness import program
        self.launches1 = program.launch_counts()

    def reduce(self) -> dict:
        """{"kernels": {name: [seconds, count]}, "busy_s", "window_s",
        "launches", "breakdown"} of the traced window."""
        events = self.prof.events()
        dev, cpu_top, spans = [], [], []
        for e in events:
            a, b = e.time_range.start, e.time_range.end
            if e.name.startswith(PREFIX):
                # a span's annotation shows on the device's timeline too
                if e.device_type != torch.autograd.DeviceType.CUDA:
                    spans.append((a, b, e.name[len(PREFIX):]))
            elif e.device_type == torch.autograd.DeviceType.CUDA:
                dev.append((a, b, e.name))
            elif e.cpu_parent is None:
                cpu_top.append((a, b, e.name))
        kernels = {}
        for a, b, name in dev:
            rec = kernels.setdefault(name, [0.0, 0])
            rec[0] += (b - a) * 1e-6
            rec[1] += 1
        dev.sort()
        merged = []
        for a, b, _ in dev:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        busy = sum(b - a for a, b in merged) * 1e-6
        gaps = {}
        holes = [(end, nxt) for (_, end), (nxt, _) in zip(merged, merged[1:])]
        in_span = _active([e for e, _ in holes], spans)
        in_op = _active([e for e, _ in holes], cpu_top)
        for (end, nxt), sp, op in zip(holes, in_span, in_op):
            if sp:
                label = "span " + min(sp)[1]
            elif op:
                label = "op " + max(op)[1]
            else:
                label = "host outside any op"
            rec = gaps.setdefault(label, [0.0, 0])
            rec[0] += (nxt - end) * 1e-6
            rec[1] += 1
        by_short = {}
        for name, (sec, _) in kernels.items():
            by_short[_short(name)] = by_short.get(_short(name), 0.0) + sec
        ops = sorted(by_short.items(), key=lambda kv: -kv[1])[:10]
        idle = sorted(gaps.items(), key=lambda kv: -kv[1][0])[:10]
        launches = {k: self.launches1[k] - self.launches0[k]
                    for k in self.launches1}
        return {"kernels": kernels, "busy_s": busy,
                "window_s": self.t_stop - self.t_start,
                "launches": launches,
                "breakdown": {
                    "device_ops": [[n, s] for n, s in ops],
                    "idle_gaps": [[f"{n} (x{c})", s] for n, (s, c) in idle]}}


def _active(points: list, intervals: list) -> list:
    """For each of the ascending ``points``, the (duration, name) of every
    interval that holds it: one sweep over the intervals by start."""
    intervals = sorted(intervals)
    out, live, j = [], [], 0
    for t in points:
        while j < len(intervals) and intervals[j][0] <= t:
            a, b, n = intervals[j]
            live.append((b, b - a, n))
            j += 1
        live = [x for x in live if x[0] >= t]
        out.append([(d, n) for _, d, n in live])
    return out
