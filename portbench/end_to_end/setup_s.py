"""s: process start to the window's start (imports, the card, the code, the
decoder, the bank made and staged, the warm-up)."""


def read(run):
    return run.setup_s
