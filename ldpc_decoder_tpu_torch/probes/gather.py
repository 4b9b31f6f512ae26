"""Row 15: a gather of scattered rows, on the card.

Replaces ``scripts/micro_gather.py:96`` ``kernel`` (``pallas_call`` at
``:128``), which gathered N = 2^21 rows of B = 128 float32 by per-row async
copies against ``jnp.take``, in random and in sorted order, and swept the
dtype and row width (``:80-92``: float32 at B = 128, 256, 512, bfloat16 at
256, 512). Here :func:`~ldpc_decoder_tpu_torch.probes.kernels.row_copy`
gathers by an int32 index, 16 bytes per thread, over the same points, and
at the general path's shape: 3·2^20 rows (its edges) of B = 384 bfloat16.
The random order is a permutation, so each source row is read once; the
sorted order is the identity. The library yardstick is
``torch.index_select`` (the counterpart of the script's ``jnp.take``; the
port never calls it).
"""

from __future__ import annotations

import torch

from ldpc_decoder_tpu_torch.probes import _common as C
from ldpc_decoder_tpu_torch.probes.kernels import row_copy, row_copy_plain

REPLACES = "scripts/micro_gather.py:96"
N_ROWS = 1 << 21
GENERAL_ROWS = 3 << 20
SWEEP = ((torch.float32, 256), (torch.float32, 512), (torch.bfloat16, 256),
         (torch.bfloat16, 512))


def _one(dev, card, n: int, width: int, dtype, order: str, plain: bool,
         shape: str) -> dict:
    src = C.randn((n, width), dtype, dev, seed=22)
    idx = C.permutation(n, dev, seed=23)
    if order == "sorted":
        idx = torch.sort(idx).values
    idx64 = idx.long()
    out = torch.empty_like(src)
    row_copy(src, index=idx, out=out)
    err = C.assert_bit_equal(out, row_copy_plain(src, index=idx),
                             f"gather {n}x{width} {dtype} {order}")
    lib = torch.empty_like(src)
    torch.index_select(src, 0, idx64, out=lib)
    C.assert_bit_equal(lib, out, "index_select")
    n_bytes = 2 * src.numel() * src.element_size() + 4 * n
    return C.record(
        "gather", REPLACES,
        {"shape": shape, "rows": n, "B": width,
         "dtype": str(dtype).removeprefix("torch."), "order": order,
         "index": "int32", "bytes_per_thread": 16},
        n_bytes, 0, card,
        ms=C.timed(dev, lambda: row_copy(src, index=idx, out=out)),
        library_ms=C.timed(dev, lambda: torch.index_select(src, 0, idx64,
                                                           out=lib)),
        plain_ms=C.timed(dev, lambda: row_copy_plain(src, index=idx),
                         reps=3) if plain else None,
        max_abs_err=err)


def run(dev: torch.device, small: bool = False, headline: bool = False,
        card: dict | None = None) -> list[dict]:
    """Random then sorted at B = 128 float32, the sweep, the general path's
    shape (headline: random, B = 128 float32)."""
    card = card or C.card(dev)
    n = 4096 if small else N_ROWS
    records = [_one(dev, card, n, 128, torch.float32, "random", headline,
                    "micro_gather")]
    if headline:
        return records
    records.append(_one(dev, card, n, 128, torch.float32, "sorted", False,
                        "micro_gather"))
    for dtype, width in SWEEP:
        records.append(_one(dev, card, n, width, dtype, "random", False,
                            "micro_gather sweep"))
    records.append(_one(dev, card, 3 * 1024 if small else GENERAL_ROWS, 384,
                        torch.bfloat16, "random", False, "general path"))
    return records
