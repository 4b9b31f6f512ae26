"""Row 12: the copy rate of the decoder's rotated read, on the card.

Replaces ``scripts/micro2.py:109`` ``copy_kernel`` (``pallas_call`` at
``:132``), which copied the d_c rotated windows of every reg36 check row
through the check pass's grid with no compute, as the TPU's DMA roofline of
that read. Here :func:`~ldpc_decoder_tpu_torch.probes.kernels.row_copy`
copies, for every check-order block of reg36 (``regular_base(16, 32, 3, 6,
seed=2)``, Z = 32,768: R·d_c = 96 blocks), the rotated variable-order block
it reads, out[e, z] = msgs_v[cn_src[e], (z + cn_shift[e]) mod Z], into
[R, d_c, Z, B] bfloat16 at B = 256, from the decoder's own grouped tables.
A second run sets every shift to 0 (the aligned copy). Bytes: the E·B·2
read once and the E·B·2 written, E = 3·2^20 (3.22 GB, bound 0.961 ms),
plus the tables. The library yardstick is ``torch.index_select`` on the
same flattened row index.

This rate, not the data sheet's 3.35 TB/s, is the ceiling the check and
variable kernels' rotated reads can reach (PERF.md §7).
"""

from __future__ import annotations

import torch

from ldpc_decoder_tpu_torch.codes.protographs import regular_base
from ldpc_decoder_tpu_torch.codes.qc import make_qc_structure
from ldpc_decoder_tpu_torch.ops.qc_decode import QCDecodeTables
from ldpc_decoder_tpu_torch.ops.qc_grouped import GroupedQCTables
from ldpc_decoder_tpu_torch.probes import _common as C
from ldpc_decoder_tpu_torch.probes.kernels import row_copy, row_copy_plain

REPLACES = "scripts/micro2.py:109"


def reg36_structure(small: bool):
    """reg36's structure (bench.py's construction), or its Z = 128 lift."""
    base = regular_base(16, 32, 3, 6, seed=2)
    if small:
        return make_qc_structure(base, Z=128, seed=1)
    return make_qc_structure(base, Z=32768, seed=1, coarse=1024, fine_mod=64,
                             min_girth=8)


def run(dev: torch.device, small: bool = False, headline: bool = False,
        card: dict | None = None, structure=None) -> list[dict]:
    """Rotated, then aligned (headline: rotated only). ``structure``: the
    reg36 QCStructure when the caller has it."""
    card = card or C.card(dev)
    s = structure if structure is not None else reg36_structure(small)
    t = GroupedQCTables.from_qc_tables(
        QCDecodeTables.from_structure(s, 0, dev))
    B = 128 if small else 256
    src = C.randn((t.nb, t.Z, B), torch.bfloat16, dev, seed=12)
    out = torch.empty_like(src)
    z = torch.arange(t.Z, device=dev)
    records = []
    for label in ("rotated", "aligned"):
        shifts = (t.cn_shift if label == "rotated"
                  else torch.zeros_like(t.cn_shift))
        row_copy(src, t.cn_src, shifts, out=out)
        ref = row_copy_plain(src, t.cn_src, shifts)
        err = C.assert_bit_equal(out, ref, f"rotated copy ({label})")
        rows = (t.cn_src.long()[:, None] * t.Z
                + (z[None, :] + shifts.long()[:, None]) % t.Z).reshape(-1)
        flat, flat_out = src.view(-1, B), out.view(-1, B)
        lib = torch.index_select(flat, 0, rows)
        C.assert_bit_equal(lib.view_as(ref), ref, "index_select")
        del ref, lib
        n_bytes = src.numel() * 2 + out.numel() * 2 + 8 * t.nb
        records.append(C.record(
            "rotated_copy", REPLACES,
            {"code": "reg36", "Z": t.Z, "blocks": t.nb, "B": B,
             "dtype": "bfloat16", "shifts": label, "bytes_per_thread": 16},
            n_bytes, 0, card,
            ms=C.timed(dev, lambda: row_copy(src, t.cn_src, shifts,
                                             out=out)),
            library_ms=C.timed(dev, lambda: torch.index_select(
                flat, 0, rows, out=flat_out)),
            plain_ms=C.timed(dev, lambda: row_copy_plain(src, t.cn_src,
                                                         shifts), reps=3),
            max_abs_err=err))
        if headline:
            break
    return records
