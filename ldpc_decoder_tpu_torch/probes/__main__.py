"""Run the probes: ``python -m ldpc_decoder_tpu_torch.probes [name ...]``.

Runs every probe of :data:`ldpc_decoder_tpu_torch.probes.PROBES` (or the
named ones) on the card and prints one JSON line per measurement: the
probe, its parameters, the kernel's ms, the unique bytes and their rate,
the bound, the plain and library times where measured, and the card's name
and power limit. Without a card it exits 1; ``--device cpu`` runs the plain
versions at a small size, with no times (the tests' path).
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from ldpc_decoder_tpu_torch.probes import PROBES, card


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m ldpc_decoder_tpu_torch."
                                 "probes", description=__doc__.split("\n")[0])
    ap.add_argument("names", nargs="*", metavar="name",
                    help=f"probes to run: {', '.join(PROBES)} (default: all)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu: the plain versions at a "
                    "small size")
    args = ap.parse_args(argv)
    unknown = sorted(set(args.names) - set(PROBES))
    if unknown:
        ap.error(f"unknown probes {unknown}; choose from {list(PROBES)}")
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("probes: no CUDA device (torch.cuda.is_available() is False); "
              "--device cpu runs the plain versions", file=sys.stderr)
        return 1
    dev_card = card(dev)
    for name in args.names or PROBES:
        for rec in PROBES[name](dev, small=dev.type == "cpu", card=dev_card):
            print(json.dumps(rec), flush=True)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
