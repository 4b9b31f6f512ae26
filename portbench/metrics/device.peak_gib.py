"""GiB: torch.cuda.max_memory_allocated() over the window (its peak
statistics reset when the window opens); moves decoded_mbps."""


def read(run):
    peak = run.window_peak_bytes
    return peak / float(1 << 30) if peak else None
