"""Mean host milliseconds of the program's ``ldpc.stage`` span, a chunk's
staging (the slot wait, the cast into the pinned slot, the queued upload),
over the chunks staged in the traced window; moves decoded_mbps."""

from pbcore import spans


def read(run):
    t = run.window.trace
    found = spans.spans(t, {"ldpc.stage"}) if t is not None else []
    if not found:
        return None
    return sum(b - a for a, b, _ in found) / len(found) / 1e3
