"""Percent of the traced window with no kernel or copy on the card: one
minus the union of the profiler's device events over their span, first
start to last end; moves decoded_mbps."""


def read(run):
    t = run.window.trace
    if t is None or not t.window_s or not t.device:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
