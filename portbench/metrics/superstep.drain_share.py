"""Percent of the supersteps launched while some lane held no frame, after
the call's pool had drained (``DecodeStats.drain_supersteps`` over
``total_supersteps``, every call or chunk of the window; counts, so they
repeat exactly on one bank); moves decoded_mbps."""


def read(run):
    stats = run.window.stats
    if not stats or not hasattr(stats[0], "drain_supersteps"):
        return None
    steps = sum(st.total_supersteps for st in stats)
    if not steps:
        return None
    return 100.0 * sum(st.drain_supersteps for st in stats) / steps
