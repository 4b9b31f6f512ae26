"""Mean milliseconds on the compute stream from one chunk's decode_end to
the next chunk's decode_start CUDA event: the card's wait for the host's
staging between chunks; moves decoded_mbps."""


def read(run):
    ms = run.window.compute_gap_ms
    return sum(ms) / len(ms) if ms else None
