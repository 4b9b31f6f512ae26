"""Percent of the traced window with the card idle while the program's
``ldpc.stage`` span is open (the slot wait, the cast into the pinned slot
and the queued upload of a chunk), each idle gap split by time over the
spans; moves decoded_mbps."""

from pbcore import spans


def read(run):
    t = run.window.trace
    if t is None:
        return None
    return spans.share(t, spans.idle_within(t, {"ldpc.stage"}))
