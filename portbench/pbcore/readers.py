"""Arithmetic that the metric readers (``metrics/<name>.py``,
``end_to_end/<name>.py``) share: the port's kernels by name in the trace,
a kernel's share of its roofline, a percentile."""

from __future__ import annotations

import math

from pbcore import yardstick

# template names of the hand-written kernels, in the demangled or mangled
# symbol (grouped family: cn_kernel, vn_kernel; regular: cn_regular_kernel,
# vn_regular_kernel; both: parity_kernel)
KERNELS = {"cn": r"(?<![A-Za-z_])cn_(regular_)?kernel",
           "vn": r"(?<![A-Za-z_])vn_(regular_)?kernel",
           "parity": r"(?<![A-Za-z_])parity_kernel"}
COPY = r"^(Memcpy|Memset)"


def roofline_share(run, which: str):
    """Percent: the least time of the traced window's passes of kernel
    ``which`` ("cn" or "vn"), their unique bytes at the card's published
    memory rate, over the device time its launches took. The passes are
    the check launches over the launches a check pass takes (one per check
    degree, or one); None when the trace holds no launch of it."""
    t = run.window.trace
    if t is None:
        return None
    secs, launches = t.kernel_time(KERNELS[which])
    cn_launches = t.kernel_time(KERNELS["cn"])[1]
    if not launches or not cn_launches:
        return None
    passes = cn_launches / yardstick.check_launches_per_pass(run.graph)
    cfg = run.cfg
    n_bytes = yardstick.pass_bytes(run.graph, cfg["Z"], cfg["B"],
                                   cfg["message_dtype"])[which]
    return 100.0 * yardstick.least_seconds(passes * n_bytes) / secs


def percentile(values, q: float) -> float:
    """The nearest-rank ``q``-th percentile."""
    s = sorted(values)
    return s[max(0, math.ceil(q / 100.0 * len(s)) - 1)]
