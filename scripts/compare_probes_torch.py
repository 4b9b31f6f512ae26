"""Time the window-stream probes of two checkouts of the port on one card.

    python3 scripts/compare_probes_torch.py OTHER [name ...]

OTHER is the root of another checkout (a parent commit unpacked with
``git archive``). The probes' headline points (rows 14a-14d; row 16 all
three ways) run under each of the two timers of this checkout's
``probes/_common.py``, ``timed`` (one launch on an idle card, the decode
kernels' timer) and ``queued_timed`` (the card spinning while the host
enqueues), in turns, OTHER, this checkout, this checkout, OTHER, each in a
process of its own that imports that checkout's ``ldpc_decoder_tpu_torch``
and builds its kernels there. Both checkouts' probes time through the
timer of the turn, loaded from this checkout's file, so their times are
taken the same way whatever a checkout's own timer; a checkout's second
timer, where it has one, is switched off. One JSON line per record, with
the checkout's label (``other`` or ``this``), the turn and the timer's
name. Needs a card.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

NAMES = ("overlap2", "overlap3", "overlap4", "overlap6", "window_read")
TIMERS = ("timed", "queued_timed")
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMON = os.path.join(HERE, "ldpc_decoder_tpu_torch", "probes", "_common.py")


def child(tree: str, label: str, turn: int, timer: str,
          names: list[str]) -> None:
    sys.path.insert(0, tree)
    import torch

    from ldpc_decoder_tpu_torch import probes
    from ldpc_decoder_tpu_torch.probes import _common

    assert probes.__file__.startswith(tree + os.sep), probes.__file__
    spec = importlib.util.spec_from_file_location("_this_common", COMMON)
    mine = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mine)
    _common.timed = getattr(mine, timer)
    if hasattr(_common, "queued_timed"):
        _common.queued_timed = lambda *args, **kwargs: None
    dev = torch.device("cuda")
    card = probes.card(dev)
    for name in names:
        for rec in probes.PROBES[name](dev, headline=name != "window_read",
                                       card=card):
            print(json.dumps({"tree": label, "turn": turn, "timer": timer,
                              **rec}), flush=True)
        torch.cuda.empty_cache()


def main(argv: list[str]) -> int:
    if argv[:1] == ["--child"]:
        child(argv[1], argv[2], int(argv[3]), argv[4], argv[5:])
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    other, names = os.path.abspath(argv[0]), argv[1:] or list(NAMES)
    for timer in TIMERS:
        for turn, (label, tree) in enumerate((("other", other),
                                              ("this", HERE), ("this", HERE),
                                              ("other", other))):
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--child", tree, label, str(turn), timer,
                            *names], check=True, cwd=tree)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
