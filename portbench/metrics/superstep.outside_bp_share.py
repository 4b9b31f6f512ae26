"""Percent of the device's busy time in the traced window spent in kernels
other than the check, variable and parity kernels (retire, refill, packing,
index and elementwise operations of the superstep); copies and sets not
counted; moves decoded_mbps."""

import re

from pbcore.readers import COPY, KERNELS


def read(run):
    t = run.window.trace
    if t is None or not t.busy_s:
        return None
    own = re.compile("|".join(KERNELS.values()))
    copy = re.compile(COPY)
    other = sum(e.us for e in t.device
                if not own.search(e.name) and not copy.search(e.name))
    return 100.0 * other / 1e6 / t.busy_s
