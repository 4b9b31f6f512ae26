"""Mean milliseconds of a superstep's turn on the compute stream, from its
flag copy to the next superstep's launch (the flag read, retire and refill
that hold the stream off BP): the program's timing events, over every
turn of the traced calls or chunks (``DecodeStats.turn_ms``); moves
decoded_mbps."""


def read(run):
    ms = [m for st in run.window.stats
          for m in (getattr(st, "turn_ms", None) or [])]
    return sum(ms) / len(ms) if ms else None
