"""The program's own host spans (``ldpc.*``, from
``ldpc_decoder_tpu_torch/runtime/tracing.py``) in a traced window, and the
card's idle time split over them.

An idle gap is a stretch between two busy intervals of
:meth:`pbcore.trace.Trace.busy_intervals`; the gaps sum to the window
less the busy time, so to ``device.idle_share``. Each gap is split by
time over the spans open during it (the profiler's clock, the one of the
device events), not named after what was open at its start as
``Trace.idle_gaps`` names it: the idle inside a set of spans plus the idle
outside every ``ldpc.*`` span is the whole idle time. Only the spans of
the thread that entered the profiler are in the trace: ``decode_streamed``
decodes on a worker thread, whose spans it does not record.
"""

from __future__ import annotations

PREFIX = "ldpc."


def spans(trace, names=None) -> list:
    """[(start_us, end_us, name)] of the trace's ``ldpc.*`` host spans (of
    ``names`` only, when given), by start."""
    return sorted(h for h in trace.host if h[2].startswith(PREFIX)
                  and (names is None or h[2] in names))


def idle_gaps(trace) -> list:
    """[(start_us, end_us)] of the card's idle gaps, in order."""
    busy = trace.busy_intervals()
    return [(a[1], b[0]) for a, b in zip(busy, busy[1:])]


def _union(intervals) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def idle_within(trace, names=None):
    """Seconds of the card's idle time while a span of ``names`` (every
    ``ldpc.*`` span by default) is open; None when the trace holds no such
    span or no device event."""
    found = spans(trace, names)
    if not found or not trace.device:
        return None
    cover, gaps = _union((a, b) for a, b, _ in found), idle_gaps(trace)
    total, j = 0.0, 0
    for a, b in gaps:  # both sorted and disjoint: one merge
        while j < len(cover) and cover[j][1] <= a:
            j += 1
        k = j
        while k < len(cover) and cover[k][0] < b:
            total += min(b, cover[k][1]) - max(a, cover[k][0])
            k += 1
    return total / 1e6


def idle_seconds(trace) -> float:
    return sum(b - a for a, b in idle_gaps(trace)) / 1e6


def idle_split(trace) -> dict:
    """{name: seconds}: the card's idle time by the innermost ``ldpc.*``
    span open (the one that started last), "" where none is open."""
    found, edges = spans(trace), []
    for i, (a, b, _) in enumerate(found):
        edges += [(a, 1, i), (b, -1, i)]
    for a, b in idle_gaps(trace):
        edges += [(a, 2, None), (b, -2, None)]
    # a stretch between two edge times takes the state after every edge
    # at its start, so the order of edges at one time does not matter
    edges.sort(key=lambda e: e[0])
    out, open_, idle, last = {}, set(), False, None
    for t, kind, i in edges:
        if idle and last is not None and t > last:
            name = found[max(open_)][2] if open_ else ""
            out[name] = out.get(name, 0.0) + (t - last) / 1e6
        last = t
        if kind == 1:
            open_.add(i)
        elif kind == -1:
            open_.discard(i)
        else:
            idle = kind == 2
    return out


def share(trace, seconds):
    """``seconds`` as a percent of the traced window, or None."""
    if seconds is None or not trace.window_s:
        return None
    return 100.0 * seconds / trace.window_s
