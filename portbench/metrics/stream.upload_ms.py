"""Mean milliseconds from a chunk's upload_start to its upload_end CUDA
event (decode_streamed's staging upload and gather on its copy stream),
over the window's chunks; moves decoded_mbps."""


def read(run):
    ms = run.window.upload_ms
    return sum(ms) / len(ms) if ms else None
