"""ms: the nearest-rank 90th percentile over every chunk of the window,
each from its hand-over to the program to its words yielded in host
memory; None where the entry times no chunks."""

from pbcore.readers import percentile


def read(run):
    lat = run.window.latencies
    return 1e3 * percentile(lat, 90) if lat else None
