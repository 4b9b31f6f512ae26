"""Mb/s: the n_vars bits of every frame whose words reached the caller in
the window, over 2^20, over the window's wall time (first hand-over of
input to the last result ready); whole calls or chunks only."""


def read(run):
    w = run.window
    return run.cfg["n_vars"] * w.frames / float(1 << 20) / w.seconds
