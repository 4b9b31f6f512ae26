"""The decode loop's and the stream's host spans (``ldpc.*``).

Tracing is on exactly while a torch profiler records: ``active()`` reads
the flag that ``torch.profiler`` sets for every thread when it starts and
clears when it stops. With it off, ``span`` enters no profiler range (one
costs microseconds even with no profiler running, the flag's read tens of
nanoseconds), and the decode loop makes no timing event.

A span is torch's light range, ``_RecordFunctionFast``: the profiler
records it as it records ``torch.profiler.record_function`` (a user
annotation on the host), at a fraction of the host time, and it makes no
copy on the GPU timeline. On an H100 host ``record_function`` ranges
lengthened a traced p41 decode by about 1 %, these by about 0.5 %.
"""

from __future__ import annotations

import contextlib

import torch
from torch.autograd import profiler as _profiler

_OFF = contextlib.nullcontext()


def active() -> bool:
    """True while a torch profiler records (from any thread)."""
    return _profiler._is_profiler_enabled


def span(name: str):
    """A profiler range named ``name`` while a profiler records, else one
    shared context that does nothing."""
    if _profiler._is_profiler_enabled:
        return torch._C._profiler._RecordFunctionFast(name)
    return _OFF
