"""Percent of the lane-iterations the window ran that served a frame: the
frames' iteration counts summed, over the global iterations times B
(DecodeStats of every call or chunk; counts, so they repeat exactly on
one bank); moves decoded_mbps."""


def read(run):
    stats = run.window.stats
    slots = sum(st.total_iterations * st.batch_size for st in stats)
    if not slots:
        return None
    return 100.0 * sum(int(st.iterations.sum()) for st in stats) / slots
