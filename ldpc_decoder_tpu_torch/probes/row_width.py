"""Row 13: copy bandwidth against the width of the contiguous row, and what
several bytes per thread buy the 1-byte dtypes.

Replaces ``scripts/micro3.py:50`` ``kernel`` (``pallas_call`` at ``:70``),
which copied d = 6 rotated blocks per node out of [96, Zq, W] bfloat16 for
R = 16 nodes at equal volume, (Zq, W) = (32768, 256), (16384, 512),
(8192, 1024), (4096, 2048), to size a lane-folded layout (G rows of Z
folded into one G·W row). The TPU's lane block becomes the bytes each
thread moves: 1, 2, 4, 8 and 16 (:func:`~ldpc_decoder_tpu_torch.probes.
kernels.row_copy`, table mode). Dtypes: bfloat16 and int8; float8_e5m2
moves the same bytes as int8, so int8 stands for both 1-byte types.

Unlike the script, whose R nodes all wrote one output block, every node
writes its own d blocks ([96, Zq, W] out), and the 96 source blocks are a
permutation (the script drew them with replacement), so every byte moved is
a unique byte: each source block read once, each output block written once.
Shifts are random in [0, Zq), the decoder's rotations (the script's were
whole tiles). The library yardstick is ``torch.index_select``.
"""

from __future__ import annotations

import torch

from ldpc_decoder_tpu_torch.probes import _common as C
from ldpc_decoder_tpu_torch.probes.kernels import (
    BYTES_PER_THREAD,
    row_copy,
    row_copy_plain,
)

REPLACES = "scripts/micro3.py:50"
POINTS = ((32768, 256), (16384, 512), (8192, 1024), (4096, 2048))
SMALL_POINTS = ((256, 128), (128, 256), (64, 512), (32, 1024))
N_BLOCKS = 96  # R = 16 nodes x d = 6 blocks
DTYPES = (torch.bfloat16, torch.int8)


def run(dev: torch.device, small: bool = False, headline: bool = False,
        card: dict | None = None) -> list[dict]:
    """Every point x dtype x bytes per thread (headline: the first point,
    int8, 16 bytes per thread)."""
    card = card or C.card(dev)
    records = []
    points = SMALL_POINTS if small else POINTS
    for Zq, W in points[:1] if headline else points:
        blocks = C.permutation(N_BLOCKS, dev, seed=13)
        shifts = C.integers(N_BLOCKS, Zq, dev, seed=14)
        z = torch.arange(Zq, device=dev)
        rows = (blocks.long()[:, None] * Zq
                + (z[None, :] + shifts.long()[:, None]) % Zq).reshape(-1)
        for dtype in DTYPES[1:] if headline else DTYPES:
            src = C.randn((N_BLOCKS, Zq, W), dtype, dev, seed=15)
            out = torch.empty_like(src)
            ref = row_copy_plain(src, blocks, shifts)
            flat, flat_out = src.view(-1, W), out.view(-1, W)
            lib_ms = C.timed(dev, lambda: torch.index_select(
                flat, 0, rows, out=flat_out))
            plain_ms = C.timed(dev, lambda: row_copy_plain(
                src, blocks, shifts), reps=3) if headline else None
            n_bytes = 2 * src.numel() * src.element_size() + 8 * N_BLOCKS
            for bpt in BYTES_PER_THREAD[-1:] if headline else \
                    BYTES_PER_THREAD:
                out.zero_()
                row_copy(src, blocks, shifts, out=out, bytes_per_thread=bpt)
                err = C.assert_bit_equal(out, ref, f"row width {Zq}x{W} "
                                         f"{dtype} {bpt} B/thread")
                records.append(C.record(
                    "row_width", REPLACES,
                    {"Zq": Zq, "W": W, "blocks": N_BLOCKS,
                     "dtype": str(dtype).removeprefix("torch."),
                     "row_bytes": W * src.element_size(),
                     "bytes_per_thread": bpt},
                    n_bytes, 0, card,
                    ms=C.timed(dev, lambda: row_copy(
                        src, blocks, shifts, out=out,
                        bytes_per_thread=bpt)),
                    library_ms=lib_ms, plain_ms=plain_ms, max_abs_err=err))
            del src, out, ref
    return records
