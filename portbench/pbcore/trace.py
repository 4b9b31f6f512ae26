"""The traced part of a window: ``torch.profiler`` (CPU and CUDA activity)
reduced to what the per-layer readers and the result's ``breakdown`` use.

Device events are every CUDA-side event of the trace: kernels (the port's
hand-written ones, launched through ctypes, are traced like torch's own),
copies and sets. Busy time is the union of their intervals; the window is
the span from the first device event's start to the last one's end (the
host clock's length of the traced part when there is none), so that the
profiler's own start and stop, during which the card runs work the trace
does not see, are not read as idle time. An idle gap is a stretch
between two busy intervals, named after the innermost host event that was
open at its start (a ``portbench.*`` span of the benchmark's own, or a
profiler event of the program's host code), so that the gaps say what the
host was doing while the card waited.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field


# the benchmark's own host spans (record_function names)
SPAN_PREFIX = "portbench."


@dataclass
class DeviceEvent:
    name: str
    start_us: float
    end_us: float

    @property
    def us(self) -> float:
        return self.end_us - self.start_us


@dataclass
class Trace:
    window_s: float
    device: list = field(default_factory=list)  # DeviceEvent
    host: list = field(default_factory=list)    # (start_us, end_us, name)

    def busy_intervals(self) -> list:
        iv = sorted((e.start_us, e.end_us) for e in self.device)
        out = []
        for a, b in iv:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def kernel_time(self, pattern: str) -> tuple[float, int]:
        """(seconds, launches) of the device events whose name matches
        ``pattern`` (a regular expression, searched)."""
        rx = re.compile(pattern)
        hits = [e for e in self.device if rx.search(e.name)]
        return sum(e.us for e in hits) / 1e6, len(hits)

    def top_ops(self, n: int = 10) -> list:
        """[[name, seconds], ...]: the device operations that took most
        time, instantiations of one template counted apart."""
        by = {}
        for e in self.device:
            by[e.name] = by.get(e.name, 0.0) + e.us / 1e6
        return [[_short(k), v] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list:
        """[[host activity, seconds], ...]: idle time between busy
        intervals, summed by what the host was doing at each gap's start,
        most first."""
        busy = self.busy_intervals()
        host = sorted(self.host)
        by, i, open_ = {}, 0, []
        for (_, a), (b, _) in zip(busy, busy[1:]):
            while i < len(host) and host[i][0] <= a:
                open_.append(host[i])
                i += 1
            open_ = [h for h in open_ if h[1] >= a]
            name = _short(open_[-1][2], 64) if open_ else "no host event"
            by[name] = by.get(name, 0.0) + (b - a) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:n]]


def _short(name: str, width: int = 96) -> str:
    return name if len(name) <= width else name[:width - 3] + "..."


def from_profiler(prof, window_s: float) -> Trace:
    """A :class:`Trace` of a finished ``torch.profiler.profile`` that ran
    for ``window_s`` seconds by the host clock."""
    t = Trace(window_s=window_s)
    for e in prof.events():
        a, b = float(e.time_range.start), float(e.time_range.end)
        if e.device_type.name != "CUDA":
            t.host.append((a, b, e.name))
        elif not (getattr(e, "is_user_annotation", False)
                  or e.name.startswith(SPAN_PREFIX)):
            # the GPU timeline's copies of host spans are not device work
            t.device.append(DeviceEvent(e.name, a, b))
    if t.device:
        t.window_s = (max(e.end_us for e in t.device)
                      - min(e.start_us for e in t.device)) / 1e6
    return t
