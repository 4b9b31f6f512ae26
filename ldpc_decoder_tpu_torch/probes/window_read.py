"""Row 16: a rotated window read three ways, on the card.

Replaces ``scripts/proto_window.py:39,52,65`` ``kern_a``/``kern_b``/
``kern_c`` (``pallas_call`` at ``:86``): a check-node-like pass that sums D
= 6 rotated windows per node, R = 3 nodes, Z = 340·512 = 174,080 rows, B =
256 frames, bfloat16, from a (D, D, Z, B) source (3.2 GB). Each window has a
tile offset t in [0, 340) and a fine offset f in [0, 512), shift t·512 + f,
as the script's table (its source blocks drawn here without replacement,
18 of the 36, so every byte read is a unique byte).

- A: staged, the TPU kernel's way: the tile pair holding the window staged
  in shared memory as float32, then read at the fine offset (``kern_a``'s
  scratch and dynamic slice);
- B: direct, ``(z + s) mod Z`` on every row, the counterpart of ``kern_b``'s
  ``pltpu.roll`` of the tile pair and the port's own design;
- C: aligned, shift t·512 only, the row index advanced from one rotation
  per block (the ceiling, ``kern_c``).

The sums are float32 from 0, left to right, stored in bfloat16
(:func:`~ldpc_decoder_tpu_torch.probes.kernels.window_stream`, k = 0).
"""

from __future__ import annotations

import torch

from ldpc_decoder_tpu_torch.probes import _common as C
from ldpc_decoder_tpu_torch.probes.phi_overlap import measure

REPLACES = "scripts/proto_window.py:39"
WAYS = {"A": "staged", "B": "direct", "C": "aligned"}


def run(dev: torch.device, small: bool = False, headline: bool = False,
        card: dict | None = None) -> list[dict]:
    """B, A and C (headline: B)."""
    card = card or C.card(dev)
    D, R = 6, 3
    T, NT, B = (64, 8, 128) if small else (512, 340, 256)
    Z = T * NT
    src = C.randn((D * D, Z, B), torch.bfloat16, dev, seed=16)
    blocks = C.permutation(D * D, dev, seed=17)[:R * D].contiguous()
    toff = C.integers(R * D, NT, dev, seed=18)
    fine = C.integers(R * D, T, dev, seed=19)
    shifts = {"A": toff * T + fine, "B": toff * T + fine, "C": toff * T}
    records = []
    for way in ("B",) if headline else ("B", "A", "C"):
        records.append(measure(
            "window_read", REPLACES,
            {"way": way, "nodes": R, "Z": Z, "B": B, "T": T,
             "source_blocks": D * D},
            dev, card, src, blocks, shifts[way].contiguous(), D, 0,
            WAYS[way], plain=headline))
    return records
