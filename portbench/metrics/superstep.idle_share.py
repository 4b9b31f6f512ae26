"""Percent of the traced window with the card idle while the program's
``ldpc.decode`` span is open (a call's first fill, flag reads, retire,
refill and final sync), each idle gap split by time over the spans;
moves decoded_mbps."""

from pbcore import spans


def read(run):
    t = run.window.trace
    if t is None:
        return None
    return spans.share(t, spans.idle_within(t, {"ldpc.decode"}))
