"""Measurement probes on the card: the counterparts of the TPU kernels in
``scripts/`` (PERF.md section 6, rows 11-16), which no decode runs.

    python -m ldpc_decoder_tpu_torch.probes [name ...]
    python -m ldpc_decoder_tpu_torch.probes --device cpu   # plain, small

Each probe is a function ``(dev, small=False, headline=False, card=None)
-> list of records`` (:data:`PROBES`): it builds its inputs on the device
from a seed, holds its kernel against the kernel's plain PyTorch version
(bit-exact for copies, gathers and sums; the compare_msgs rule for φ),
times it with CUDA events and returns one JSON-ready record per
measurement (:func:`._common.record`). ``headline=True`` runs one point.
On the CPU the probes run their plain versions at a small size and take no
times. The two kernels live in ``csrc/probes.cu``
(:mod:`.kernels`); row 11 runs the decoder's grouped kernels.
"""

from __future__ import annotations

import torch

from ldpc_decoder_tpu_torch.probes import (
    gather,
    noalias,
    phi_overlap,
    rotated_copy,
    row_width,
    window_read,
)
from ldpc_decoder_tpu_torch.probes import _common as C
from ldpc_decoder_tpu_torch.probes.kernels import (
    BYTES_PER_THREAD,
    FAST_SHAPES,
    WINDOW_SHAPES,
    row_copy,
    row_copy_plain,
    window_stream,
    window_stream_plain,
)

card = C.card

# name -> probe, in PERF.md's row order
PROBES = {
    "noalias": noalias.run,            # row 11
    "rotated_copy": rotated_copy.run,  # row 12
    "row_width": row_width.run,        # row 13
    "overlap2": phi_overlap.overlap2,  # row 14
    "overlap3": phi_overlap.overlap3,
    "overlap4": phi_overlap.overlap4,
    "overlap6": phi_overlap.overlap6,
    "gather": gather.run,              # row 15
    "window_read": window_read.run,    # row 16
}


def check_template_modes(dev: torch.device, small: bool = False) -> dict:
    """Every mode of both kernels against its plain version, at full size
    (the probes' own shapes): the row copy by table, int32 and int64 index
    at every bytes-per-thread; the window stream's sums of every degree and
    k, φ live and stubbed, and its leave-one-out, each aligned, direct and
    staged, live on the accurate φ and, at the fast φ's shapes, on the
    fast one. Bit for bit where no φ runs, live φ by compare_msgs (accurate)
    or compare_msgs_fast (fast). Returns {mode: max absolute error}."""
    errs = {}
    Z, W = (256, 128) if small else (32768, 256)
    src = C.randn((96, Z, W), torch.bfloat16, dev, seed=1)
    blocks = C.permutation(96, dev, seed=2)
    shifts = C.integers(96, Z, dev, seed=3)
    ref = row_copy_plain(src, blocks, shifts)
    for bpt in BYTES_PER_THREAD:
        errs[f"row_copy table {bpt} B"] = C.assert_bit_equal(
            row_copy(src, blocks, shifts, bytes_per_thread=bpt), ref,
            f"row copy, table, {bpt} B/thread")
    del src, ref
    n = 4096 if small else 1 << 21
    src = C.randn((n, 128), torch.float32, dev, seed=4)
    idx = C.permutation(n, dev, seed=5)
    ref = row_copy_plain(src, index=idx)
    for index in (idx, idx.long()):
        for bpt in BYTES_PER_THREAD:
            what = f"row_copy {str(index.dtype)[6:]} index {bpt} B"
            errs[what] = C.assert_bit_equal(
                row_copy(src, index=index, bytes_per_thread=bpt), ref, what)
    del src, ref

    nodes, Z, W, NB = (2, 256, 128, 16) if small else (16, 18432, 256, 176)
    src = C.randn((NB, Z, W), torch.bfloat16, dev, seed=6, offset=1.5)
    perm = C.permutation(NB, dev, seed=7)
    syn = C.randn((nodes, Z, W), torch.int8, dev, seed=8).bitwise_and_(1)
    cases = [("sum", d, k, live, "accurate")
             for d, k in sorted(WINDOW_SHAPES["sum"])
             for live in ((True,) if k == 0 else (True, False))]
    cases += [("loo", d, k, live, "accurate")
              for d, k in sorted(WINDOW_SHAPES["loo"])
              for live in (True, False)]
    cases += [(out, d, k, True, "fast") for out in ("sum", "loo")
              for d, k in sorted(FAST_SHAPES[out])]
    for out, d, k, live, phi in cases:
        blocks = perm[:nodes * d].contiguous()
        shifts = C.integers(nodes * d, Z, dev, seed=9 + d)
        s = syn if out == "loo" else None
        ref = window_stream_plain(src, blocks, shifts, d, k, out, live, s)
        check = C.window_rule(k, live, phi)
        for mode in ("aligned", "direct", "staged"):
            what = (f"window {out} d={d} k={k} "
                    f"{phi if live else 'stub'} {mode}")
            res = window_stream(src, blocks, shifts, d, k, mode, out, live,
                                s, phi=phi)
            errs[what] = check(res, ref, what)
    return errs
