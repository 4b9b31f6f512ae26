"""Percent of the traced window with the card idle while no ``ldpc.*``
span of the program is open: the caller's own time between calls or
chunks. With the idle inside the program's spans it makes up
device.idle_share; moves decoded_mbps."""

from pbcore import spans


def read(run):
    t = run.window.trace
    if t is None:
        return None
    inside = spans.idle_within(t)
    if inside is None:
        return None
    return spans.share(t, spans.idle_seconds(t) - inside)
