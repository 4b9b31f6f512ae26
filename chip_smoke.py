#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths once on one NVIDIA GPU, and check them.

    python3 chip_smoke.py        # from the repository root, one card

Six paths, each through ``LDPCDecoder.decode`` with frames generated on
the host, at most 120 iterations. The QC sum-product paths run on bfloat16
messages with B = 256 frames in flight:

- p41 (the bench's flagship): the punctured p41 code (n = 1,032,192,
  147,456 punctured), BI-AWGN at sigma = 0.94, 512 frames, k = 14, first
  parity check at iteration 70 — the grouped kernels (csrc/qc_grouped.cu);
- reg36 (the README's library flow, bench.py's secondary point): the
  regular (3,6) code of n = 2^20 (Z = 32,768), BI-AWGN at sigma = 0.87,
  512 frames, then the erasure channel at epsilon = 0.40, 256 frames; k =
  10, first check 0 — the regular kernels (csrc/qc_regular.cu).

The general (any-alist) paths decode a random non-QC (3,6) code of n = 2^20
(``make_regular_code(2**20, 3, 6, seed=9)``, the JAX package's
scripts/bench_general.py code) at sigma = 0.84, 768 frames, k = 10, through
the general kernels (csrc/general.cu):

- sum-product, bfloat16, B = 384 (two fills, so the refill runs);
- int8 min-sum (alpha 0.8, offset 0, scale 4), B = 768 (one fill).

The QC min-sum paths decode reg36 rebuilt as a plain code (no structure
given: the decoder detects it) with offset min-sum at the defaults (alpha
1, offset 0.5, clamp 64, scale 4), BI-AWGN at sigma = 0.84, 512 frames,
B = 256, k = 10, through the min-sum kernels (csrc/qc_minsum.cu):

- bfloat16, the regular family;
- int8, the grouped family (every int8 decode takes it, as in JAX).

The float8_e5m2 paths decode with sum-product on float8_e5m2 messages and
a bfloat16 LLR state, B = 256, through the sum-product kernels' float8
instantiations (the regular family clamps phi's input at 10, the grouped
one at 80, as the JAX kernels do):

- reg36 at sigma = 0.87, 512 frames, k = 10 (the regular family);
- p41 at sigma = 0.94, 512 frames, k = 14, first check 70 (the grouped
  family); its FER, BER and iterations are recorded, not gated.

The CLI (``python -m ldpc_decoder_tpu_torch.cli``, the JAX CLI's flags)
decodes reg36 from its cached alist, 512 frames at sigma = 0.87 in
bfloat16 at log level 2, in process, then a small QC code in a subprocess.

The probes (``python -m ldpc_decoder_tpu_torch.probes``, the counterparts
of the TPU measurement kernels in scripts/) run one headline point each at
full size: the grouped kernels writing fresh outputs at p41 x B = 256
(row 11), and the two probe kernels of csrc/probes.cu, the row copy
(rotated reg36 copy, row width, gather: rows 12, 13, 15) and the window
stream (phi under traffic, rotated window reads: rows 14, 16).

Phases:

1. device: the card's name and power limit (nvidia-smi);
2. build: the five kernel libraries from ldpc_decoder_tpu_torch/csrc/,
   one nvcc each, started together;
3. the numerics smoke (``runtime.smoke.cuda_numerics_smoke``): phi on the
   device, through check-node launches, against float64, and phi(10) in
   float8_e5m2;
4. the p41 code (alist cache in codes_cache/) and 512 frames on the host;
5. each grouped kernel against its plain PyTorch version on the card, at
   p41 x B = 256 on a real decode state, with both times;
6. a small p41 decode on the card against the plain passes on the CPU;
7. the p41 path, twice; the second decode is reported, and the kernels'
   launch counts are read around it;
8. the reg36 code (alist cache) and its frames: 512 at sigma = 0.87, 256
   over the erasure channel;
9. each regular kernel against its plain version at reg36 x B = 256 on a
   real decode state, and against the grouped kernel on the same state,
   with the three times;
10. a small regular decode on the card against the plain passes on the CPU;
11. the reg36 path, twice, reported and counted like phase 7;
12. the reg36 erasure decode, counted the same way;
13. the general code (generated and compiled, timed) and 768 frames;
14. each general kernel against its plain version on the card, at full
    width on a real decode state: sum-product bf16 at B = 384, int8
    min-sum at B = 768 and bf16 min-sum at B = 384, with both times;
15. a small multi-bucket irregular decode (degree-1 variables) on the card
    against the plain passes on the CPU, f32 sum-product and int8 min-sum;
16. the general sum-product path, twice, counted like phase 7;
17. the general int8 min-sum path, twice, counted the same way;
18. the grouped min-sum kernels against their plain versions at p41 x
    B = 256, int8, a per-degree alpha table and offset 0.5, every group
    (the degree-1 one too), with and without fresh lanes, bitwise;
19. reg36 rebuilt as a plain code, 512 frames at sigma = 0.84, and the
    detection of its structure, timed (and of its interleaved renumbering);
20. the QC min-sum kernels against their plain versions at reg36 x
    B = 256: regular bf16 and grouped int8, bitwise, with both times;
21. small QC min-sum decodes on the card against the plain passes on the
    CPU: regular-base bf16, regular-base int8 (grouped), and a small p41
    lift in int8 with the alpha table; words and per-frame iterations
    equal;
22. detection: a small aligned QC code and its interleaved renumbering
    decode to the same words on the card; a random code takes the general
    path;
23. the reg36 bf16 min-sum path, twice, counted like phase 7;
24. the reg36 int8 min-sum path, twice, counted the same way;
25. the float8_e5m2 kernels against their plain versions at full width on
    real decode states (the frames of phases 4 and 8): the regular
    sum-product and min-sum kernels at reg36 x B = 256, the grouped ones
    at p41 x B = 256 (every group), with fresh lanes and emits;
26. small float8_e5m2 decodes on the card against the plain passes on the
    CPU (a regular base, p41 at Z = 128 in sum-product and min-sum); words
    and per-frame iterations equal;
27. the reg36 float8_e5m2 path, twice, counted like phase 7;
28. the p41 float8_e5m2 path, twice, counted the same way, the two
    decodes' words equal;
29. the CLI: reg36 in process (BER 0, no frame in error, iterations in
    phase 11's band, phase timings printed), and a subprocess on a small
    QC code.
30. the probes: every mode of both probe kernels against its plain version
    at full size, then each probe's headline point through the probe
    entry point's functions, its records printed, its launches counted
    like a path's (row 11: the grouped kernels' fresh outputs bit-identical
    to the in-place run over 14 iterations).

Every phase must pass: any failure raises, and the script exits nonzero
without its result line. The last line of stdout is the result object; the
line before it lists the kernels. Imports nothing of JAX.
"""

import json
import os
import re
import subprocess
import sys
import threading
import time

# the median of CUDA-event runs after a warm-up; the least time of a piece
# of work at the card's data-sheet rates (H100 SXM, 700 W); the rules a
# kernel is held to against its plain version, and the float32 operations
# per sum-product message
from ldpc_decoder_tpu_torch.runtime import perf
from ldpc_decoder_tpu_torch.runtime.perf import (
    OPS_PER_MESSAGE,
    bit_identical,
    bound,
    cuda_ms,
)

REPO = os.path.dirname(os.path.abspath(__file__))
P41_ALIST = os.path.join(REPO, "codes_cache",
                         "code_awgn_rate_0.5_thr_0.95.alist")
# bench.py's cache file and #params header for the regular (3,6) code
REG36_ALIST = os.path.join(REPO, "codes_cache",
                           "bench_qc36x_awgn_r05_1048576_g8.alist")
REG36_PARAMS = {"base": "reg36_16x32_s2", "Z": "32768", "seed": "1",
                "coarse": "1024", "fine_mod": "64", "min_girth": "8"}
SIGMA = 0.94
REG36_SIGMA = 0.87
EPSILON = 0.40
N_FRAMES = 512
N_ERASURE_FRAMES = 256
AVG_ITERS = (69.0, 76.0)         # p41 at sigma 0.94
REG36_AVG_ITERS = (40.0, 45.0)   # reg36 at sigma 0.87, k = 10
ERASURE_MAX_AVG_ITERS = 40.0     # reg36 at epsilon 0.40, k = 10
GENERAL_SIGMA = 0.84
N_GENERAL_FRAMES = 768
GENERAL_AVG_ITERS = (20.0, 30.0)         # sum-product, k = 10
GENERAL_MINSUM_AVG_ITERS = (20.0, 40.0)  # int8 min-sum, k = 10
MINSUM_SIGMA = 0.84     # the README's offset min-sum point on reg36
MINSUM_AVG_ITERS = (20.0, 40.0)  # reg36 offset min-sum, bf16 and int8
# reg36 float8_e5m2 sum-product at sigma 0.87, k = 10 (JAX, commit
# cb2eb0c: FER 0 at about 3 iterations over bfloat16's 41.6)
REG36_FP8_AVG_ITERS = (40.0, 50.0)
# the small QC code of the CLI's subprocess run (git-ignored cache)
CLI_SMALL_ALIST = os.path.join(REPO, "codes_cache", "cli_qc36_z128.alist")
# per-degree alpha of the p41 check degrees (3, 6, 7), with the fallback
MINSUM_ALPHA_TABLE = {3: 0.8, 6: 0.75, 7: 0.75, 0: 0.8}
# float32 operations per parity read: one add and one AND
OPS_PER_PARITY_READ = 2
# min-sum: |m|, a compare and two selects for the two minima, the leave-
# one-out select, a multiply, a subtract, a max, the sign OR, and the int8
# dequantize/quantize multiply, round and clamp
OPS_PER_MINSUM_MESSAGE = 12

GROUPED_SOURCE = "ldpc_decoder_tpu_torch/csrc/qc_grouped.cu"
REGULAR_SOURCE = "ldpc_decoder_tpu_torch/csrc/qc_regular.cu"
GENERAL_SOURCE = "ldpc_decoder_tpu_torch/csrc/general.cu"
MINSUM_SOURCE = "ldpc_decoder_tpu_torch/csrc/qc_minsum.cu"
PROBES_SOURCE = "ldpc_decoder_tpu_torch/csrc/probes.cu"
# (name in the kernels line and in launch_counts, source, TPU kernel)
KERNELS = [
    ("cn", GROUPED_SOURCE,
     "ldpc_decoder_tpu/ops/qc_pallas_grouped.py:332"),  # _cn_kernel_g
    ("vn", GROUPED_SOURCE,
     "ldpc_decoder_tpu/ops/qc_pallas_grouped.py:414"),  # _vn_kernel_g
    ("parity", GROUPED_SOURCE,
     "ldpc_decoder_tpu/ops/qc_pallas_grouped.py:462"),  # _parity_kernel_g
    ("cn_regular", REGULAR_SOURCE,
     "ldpc_decoder_tpu/ops/qc_pallas.py:412"),  # _cn_kernel
    ("vn_regular", REGULAR_SOURCE,
     "ldpc_decoder_tpu/ops/qc_pallas.py:469"),  # _vn_kernel
    ("parity_regular", REGULAR_SOURCE,
     "ldpc_decoder_tpu/ops/qc_pallas.py:732"),  # _parity_kernel
    ("cn_general", GENERAL_SOURCE,
     "ldpc_decoder_tpu/ops/general_pallas.py:252"),  # _cn_kernel
    ("vn_general", GENERAL_SOURCE,
     "ldpc_decoder_tpu/ops/general_pallas.py:280"),  # _vn_kernel
    ("cn_general_minsum", GENERAL_SOURCE,
     "ldpc_decoder_tpu/ops/general_pallas.py:308"),  # _cn_kernel_minsum
    ("vn_general_minsum", GENERAL_SOURCE,
     "ldpc_decoder_tpu/ops/general_pallas.py:350"),  # _vn_kernel_minsum
    # the min-sum and int8 branches of kernels 1, 2, 4 and 5
    ("cn_group_minsum", MINSUM_SOURCE,
     "ldpc_decoder_tpu/ops/qc_pallas_grouped.py:332"),  # _cn_kernel_g
    ("vn_group_minsum", MINSUM_SOURCE,
     "ldpc_decoder_tpu/ops/qc_pallas_grouped.py:414"),  # _vn_kernel_g
    ("cn_regular_minsum", MINSUM_SOURCE,
     "ldpc_decoder_tpu/ops/qc_pallas.py:412"),  # _cn_kernel
    ("vn_regular_minsum", MINSUM_SOURCE,
     "ldpc_decoder_tpu/ops/qc_pallas.py:469"),  # _vn_kernel
    # the float8_e5m2 sum-product branches of kernels 1, 2, 4 and 5
    ("cn_fp8", GROUPED_SOURCE,
     "ldpc_decoder_tpu/ops/qc_pallas_grouped.py:332"),  # _cn_kernel_g
    ("vn_fp8", GROUPED_SOURCE,
     "ldpc_decoder_tpu/ops/qc_pallas_grouped.py:414"),  # _vn_kernel_g
    ("cn_regular_fp8", REGULAR_SOURCE,
     "ldpc_decoder_tpu/ops/qc_pallas.py:412"),  # _cn_kernel
    ("vn_regular_fp8", REGULAR_SOURCE,
     "ldpc_decoder_tpu/ops/qc_pallas.py:469"),  # _vn_kernel
]
GROUPED = ("cn", "vn", "parity")
REGULAR = ("cn_regular", "vn_regular", "parity_regular")
GENERAL_SP = ("cn_general", "vn_general")
GENERAL_MS = ("cn_general_minsum", "vn_general_minsum")
QC_MS_REGULAR = ("cn_regular_minsum", "vn_regular_minsum", "parity_regular")
QC_MS_GROUPED = ("cn_group_minsum", "vn_group_minsum", "parity")
FP8_GROUPED = ("cn_fp8", "vn_fp8", "parity")
FP8_REGULAR = ("cn_regular_fp8", "vn_regular_fp8", "parity_regular")
# the probes of rows 11-16: (name in the kernels line, probe of
# ldpc_decoder_tpu_torch.probes.PROBES, source, launch counters)
PROBE_ROWS = [
    ("probe_noalias", "noalias", GROUPED_SOURCE, ("cn", "vn", "parity")),
    ("probe_rotated_copy", "rotated_copy", PROBES_SOURCE,
     ("probe_row_copy",)),
    ("probe_row_width", "row_width", PROBES_SOURCE, ("probe_row_copy",)),
    ("probe_overlap2", "overlap2", PROBES_SOURCE, ("probe_window",)),
    ("probe_overlap3", "overlap3", PROBES_SOURCE, ("probe_window",)),
    ("probe_overlap4", "overlap4", PROBES_SOURCE, ("probe_window",)),
    ("probe_overlap6", "overlap6", PROBES_SOURCE, ("probe_window",)),
    ("probe_gather", "gather", PROBES_SOURCE, ("probe_row_copy",)),
    ("probe_window_read", "window_read", PROBES_SOURCE, ("probe_window",)),
]


def log(msg):
    print(msg, flush=True)


T_START = time.perf_counter()


def phase(number, title):
    log(f"[{number}] {title} (at {time.perf_counter() - T_START:.1f} s)")


def cached_code(path, want, build):
    """(code, structure, how) from the alist cache at ``path`` when its
    #params header equals ``want``, else built by ``build()`` and cached."""
    from ldpc_decoder_tpu_torch.codes.qc import (
        load_qc_alist,
        read_alist_params,
        write_qc_alist,
    )

    if os.path.exists(path) and read_alist_params(path) == want:
        code, s = load_qc_alist(path)
        if s is not None:
            return code, s, "cache"
    code, s = build()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    write_qc_alist(code, s, path, params=want)
    return code, s, "built"


def get_code():
    """p41, the same file and header as bench.py."""
    from ldpc_decoder_tpu_torch.codes.protographs import (
        p41_code,
        p41_shipped_params,
    )

    return cached_code(P41_ALIST, p41_shipped_params(), p41_code)


def get_reg36_code():
    """The README's regular (3,6) 2^20 code, the same file, header and
    construction as bench.py's get_reg36_code."""
    from ldpc_decoder_tpu_torch.codes.protographs import regular_base
    from ldpc_decoder_tpu_torch.codes.qc import make_qc_code

    def build():
        return make_qc_code(regular_base(16, 32, 3, 6, seed=2), Z=32768,
                            seed=1, coarse=1024, fine_mod=64, min_girth=8)

    return cached_code(REG36_ALIST, REG36_PARAMS, build)


def popcount_rows(x):
    import numpy as np

    x = np.ascontiguousarray(x, dtype=np.uint32)
    return np.unpackbits(x.view(np.uint8), axis=1).sum(axis=1)


def compare_msgs(name, k, p):
    """Kernel vs plain messages by ``runtime.perf.compare_msgs``'s rule
    (signs exact; bf16 one ulp, float8_e5m2 one step, on a share of at most
    1e-4); logs the share. Returns the max absolute difference."""
    max_abs, share = perf.compare_msgs(name, k, p)
    log(f"  {name}: {share:.3e} of values differ (max |diff| {max_abs:.3e})")
    return max_abs


def ptxas_entries(text):
    """[(kernel, registers, spill bytes)] from an nvcc -Xptxas -v log."""
    out = []
    for chunk in text.split("Compiling entry function '")[1:]:
        name = chunk.split("'", 1)[0]
        regs = re.search(r"Used (\d+) registers", chunk)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", chunk)
        out.append((name, int(regs.group(1)) if regs else -1,
                    int(spill.group(1)) + int(spill.group(2))
                    if spill else -1))
    return out


def phase_build():
    """All libraries at once (one nvcc each), then loaded and checked."""
    from ldpc_decoder_tpu_torch.ops import _kernels

    paths, errors, secs = {}, {}, {}

    def build(name):
        t0 = time.perf_counter()
        try:
            paths[name] = _kernels.library_path(name)
        except Exception as e:  # reported below, then re-raised
            errors[name] = e
        secs[name] = time.perf_counter() - t0

    threads = [threading.Thread(target=build, args=(name,))
               for name in _kernels.SOURCES]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    for name, e in errors.items():
        raise RuntimeError(f"building {name} failed") from e
    for name, path in paths.items():
        _kernels.load(name)
        with open(path + ".log") as f:
            entries = ptxas_entries(f.read())
        log(f"  {name}.cu -> {os.path.relpath(path, REPO)} in "
            f"{secs[name]:.1f} s; {len(entries)} kernels, max "
            f"{max((r for _, r, _ in entries), default=0)} registers, "
            f"{sum(max(s, 0) for _, _, s in entries)} spill bytes")
        if name == "qc_regular":
            for kname, regs, spill in entries:
                if "Li30E" in kname and "vn_" not in kname:
                    log(f"    d = 30: {kname}: {regs} registers, {spill} "
                        f"spill bytes")


def lane_state(torch, np, dev, t, ch, batch, B):
    """The first B frames of ``batch`` as sorted bf16 llr [C, Z, B] and
    syndromes [R, Z, B] on the card."""
    vals = torch.from_numpy(np.ascontiguousarray(
        batch.values[t.vn_order.cpu().numpy(), :B])).to(dev)
    llr = ch.llr_from_channel(vals).masked_fill(
        t.erased_mask_sorted, 0.0).to(torch.bfloat16).view(t.C, t.Z, B)
    syn = torch.from_numpy(np.ascontiguousarray(
        batch.syndromes[t.cn_order.cpu().numpy(), :B])).to(dev).view(
        t.R, t.Z, B)
    return llr, syn


def phase_kernels(torch, np, dev, code, s, batch):
    """Grouped kernel vs plain at the p41 path's shapes on a real decode
    state."""
    from ldpc_decoder_tpu_torch.channels import BIAWGNChannel
    from ldpc_decoder_tpu_torch.ops import qc_grouped as qg
    from ldpc_decoder_tpu_torch.ops.qc_decode import QCDecodeTables
    from ldpc_decoder_tpu_torch.runtime import perf

    t = qg.GroupedQCTables.from_qc_tables(
        QCDecodeTables.from_structure(s, code.n_erased_vars, dev))
    B = 256
    llr, syn = lane_state(torch, np, dev, t, BIAWGNChannel(SIGMA), batch, B)
    msgs = qg.init_messages_qc_grouped(llr, t, torch.bfloat16)
    msgs, _, _ = qg.run_iterations_qc_grouped(msgs, llr, syn, t, 4)
    mv, rc = msgs
    fresh = torch.zeros(B, dtype=torch.bool, device=dev)
    fresh[::5] = True
    out = {}

    log("  check nodes:")
    rk, rp = torch.empty_like(rc), torch.empty_like(rc)
    qg.cn_pass_grouped(mv, syn, rk, t)
    qg.cn_pass_plain(mv, syn, rp, t)
    err = compare_msgs("r_c", rk, rp)
    del rp
    passes = perf.grouped_bytes(t, B, 2, 2)  # bf16 messages and llr
    out["cn"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: qg.cn_pass_grouped(mv, syn, rk, t), 10),
        plain_ms=cuda_ms(lambda: qg.cn_pass_plain(mv, syn, rk, t), 3),
        bound=bound(passes["cn"], OPS_PER_MESSAGE * t.nb * t.Z * B))

    log("  variable nodes:")
    errs = []
    mk, mp = mv.clone(), mv.clone()
    for label, emit, fr, d1 in [("plain iteration", False, None, False),
                                ("emit + fresh lanes", True, fresh, False),
                                ("first after refill", False, fresh, True)]:
        mk.copy_(mv)
        mp.copy_(mv)
        bk = torch.full((t.C, t.Z, B), -1, dtype=torch.int8, device=dev)
        bp = bk.clone()
        qg.vn_pass_grouped(rk, llr, mk, t, bits=bk if emit else None,
                           fresh=fr, include_d1=d1)
        qg.vn_pass_plain(rk, llr, mp, t, bits=bp if emit else None,
                         fresh=fr, include_d1=d1)
        errs.append(compare_msgs(f"msgs_v ({label})", mk, mp))
        assert torch.equal(bk, bp), f"hard bits differ ({label})"
        if emit:
            emitted = bk
            log(f"  hard bits ({label}): equal")
    del mp
    # the timed pass is a plain iteration: the degree-1 group is skipped
    blocks = sum(g.count * g.degree for g in t.col_groups if g.degree > 1)
    out["vn"] = dict(
        max_abs_err=max(errs),
        ms=cuda_ms(lambda: qg.vn_pass_grouped(rk, llr, mk, t), 10),
        plain_ms=cuda_ms(lambda: qg.vn_pass_plain(rk, llr, mk, t), 3),
        bound=bound(passes["vn"], OPS_PER_MESSAGE * blocks * t.Z * B))

    log("  parity:")
    ref = torch.from_numpy(np.ascontiguousarray(
        batch.ref_bits[t.vn_order.cpu().numpy(), :B])).to(dev).view(
        t.C, t.Z, B)
    syn_bad = syn.clone()
    bad = [3, 77, 200]
    syn_bad[t.R - 1, t.Z - 1, bad] ^= 1
    for label, bits, sy, want in [
            ("decode state", emitted, syn, None),
            ("codewords", ref, syn, []),
            ("codewords, 3 checks flipped", ref, syn_bad, bad)]:
        fk = qg.parity_pass_grouped(bits, sy, t)
        fp = qg.parity_pass_plain(bits, sy, t)
        assert torch.equal(fk, fp), f"parity flags differ ({label})"
        lanes = torch.nonzero(fk).flatten().tolist()
        if want is not None:
            assert lanes == want, f"parity ({label}): {lanes} != {want}"
        log(f"  flags ({label}): equal, {len(lanes)} of {B} lanes violated")
    out["parity"] = dict(
        max_abs_err=0.0,
        ms=cuda_ms(lambda: qg.parity_pass_grouped(emitted, syn, t), 10),
        plain_ms=cuda_ms(lambda: qg.parity_pass_plain(emitted, syn, t), 3),
        bound=bound(passes["parity"], OPS_PER_PARITY_READ * t.nb * t.Z * B))
    for name, r in out.items():
        log(f"  {name}: kernel {r['ms']:.3f} ms per pass, plain "
            f"{r['plain_ms']:.3f} ms, bound {r['bound'][0]:.3f} ms "
            f"({r['bound'][1]}) (p41, B = {B}, bf16)")
    return out


def phase_regular_kernels(torch, np, dev, code, s, batch):
    """Regular kernel vs plain at the reg36 path's shapes on a real decode
    state, and vs the grouped kernel on the same state."""
    from ldpc_decoder_tpu_torch.channels import BIAWGNChannel
    from ldpc_decoder_tpu_torch.ops import qc_grouped as qg
    from ldpc_decoder_tpu_torch.ops import qc_regular as qr
    from ldpc_decoder_tpu_torch.ops.qc_decode import QCDecodeTables
    from ldpc_decoder_tpu_torch.runtime import perf

    qct = QCDecodeTables.from_structure(s, code.n_erased_vars, dev)
    t = qr.QCRegularTables.from_qc_tables(qct)
    tg = qg.GroupedQCTables.from_qc_tables(qct)
    B = 256
    llr, syn = lane_state(torch, np, dev, t, BIAWGNChannel(REG36_SIGMA),
                          batch, B)
    msgs = qr.init_messages_qc_regular(llr, t, torch.bfloat16)
    msgs, _, _ = qr.run_iterations_qc_regular(msgs, llr, syn, t, 4)
    mv, rc = msgs
    nb, Z = tg.nb, t.Z
    fresh = torch.zeros(B, dtype=torch.bool, device=dev)
    fresh[::5] = True
    out, same = {}, {}

    log("  check nodes:")
    rk, rp = torch.empty_like(rc), torch.empty_like(rc)
    rg = torch.empty((nb, Z, B), dtype=rc.dtype, device=dev)
    qr.cn_pass_regular(mv, syn, rk, t)
    qr.cn_pass_plain(mv, syn, rp, t)
    qg.cn_pass_grouped(mv.view(nb, Z, B), syn, rg, tg)
    err = compare_msgs("r_c", rk, rp)
    same["r_c"] = bit_identical(rk, rg)
    del rp
    passes = perf.regular_bytes(t, B, 2, 2)  # bf16 messages and llr
    out["cn_regular"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: qr.cn_pass_regular(mv, syn, rk, t), 10),
        plain_ms=cuda_ms(lambda: qr.cn_pass_plain(mv, syn, rk, t), 3),
        grouped_ms=cuda_ms(lambda: qg.cn_pass_grouped(
            mv.view(nb, Z, B), syn, rg, tg), 10),
        bound=bound(passes["cn"], OPS_PER_MESSAGE * t.n_edges * B))

    log("  variable nodes:")
    errs = []
    mk, mp = mv.clone(), mv.clone()
    mg = torch.empty((nb, Z, B), dtype=mv.dtype, device=dev)
    for label, emit, fr in [("plain iteration", False, None),
                            ("emit + fresh lanes", True, fresh),
                            ("first after refill", False, fresh)]:
        mk.copy_(mv)
        mp.copy_(mv)
        mg.copy_(mv.view(nb, Z, B))
        bk = torch.full((t.C, Z, B), -1, dtype=torch.int8, device=dev)
        bp, bg = bk.clone(), bk.clone()
        qr.vn_pass_regular(rk, llr, mk, t, bits=bk if emit else None,
                           fresh=fr)
        qr.vn_pass_plain(rk, llr, mp, t, bits=bp if emit else None,
                         fresh=fr)
        qg.vn_pass_grouped(rk.view(nb, Z, B), llr, mg, tg,
                           bits=bg if emit else None, fresh=fr,
                           include_d1=fr is not None)
        errs.append(compare_msgs(f"msgs_v ({label})", mk, mp))
        assert torch.equal(bk, bp), f"hard bits differ ({label})"
        same[f"msgs_v ({label})"] = bit_identical(mk, mg)
        if emit:
            emitted = bk
            same["bits"] = torch.equal(bk, bg)
            log(f"  hard bits ({label}): equal")
    del mp
    out["vn_regular"] = dict(
        max_abs_err=max(errs),
        ms=cuda_ms(lambda: qr.vn_pass_regular(rk, llr, mk, t), 10),
        plain_ms=cuda_ms(lambda: qr.vn_pass_plain(rk, llr, mk, t), 3),
        grouped_ms=cuda_ms(lambda: qg.vn_pass_grouped(
            rk.view(nb, Z, B), llr, mg, tg), 10),
        bound=bound(passes["vn"], OPS_PER_MESSAGE * t.n_edges * B))

    log("  parity:")
    ref = torch.from_numpy(np.ascontiguousarray(
        batch.ref_bits[t.vn_order.cpu().numpy(), :B])).to(dev).view(
        t.C, Z, B)
    syn_bad = syn.clone()
    bad = [3, 77, 200]
    syn_bad[t.R - 1, Z - 1, bad] ^= 1
    flags_same = True
    for label, bits, sy, want in [
            ("decode state", emitted, syn, None),
            ("codewords", ref, syn, []),
            ("codewords, 3 checks flipped", ref, syn_bad, bad)]:
        fk = qr.parity_pass_regular(bits, sy, t)
        fp = qr.parity_pass_plain(bits, sy, t)
        assert torch.equal(fk, fp), f"parity flags differ ({label})"
        flags_same &= torch.equal(fk, qg.parity_pass_grouped(bits, sy, tg))
        lanes = torch.nonzero(fk).flatten().tolist()
        if want is not None:
            assert lanes == want, f"parity ({label}): {lanes} != {want}"
        log(f"  flags ({label}): equal, {len(lanes)} of {B} lanes violated")
    same["flags"] = flags_same
    out["parity_regular"] = dict(
        max_abs_err=0.0,
        ms=cuda_ms(lambda: qr.parity_pass_regular(emitted, syn, t), 10),
        plain_ms=cuda_ms(lambda: qr.parity_pass_plain(emitted, syn, t), 3),
        grouped_ms=cuda_ms(lambda: qg.parity_pass_grouped(emitted, syn, tg),
                           10),
        bound=bound(passes["parity"], OPS_PER_PARITY_READ * t.n_edges * B))
    log(f"  regular kernel vs grouped kernel on the same state, "
        f"bit-identical: {same}")
    for name, r in out.items():
        log(f"  {name}: kernel {r['ms']:.3f} ms per pass, grouped kernel "
            f"{r['grouped_ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, bound "
            f"{r['bound'][0]:.3f} ms ({r['bound'][1]}) (reg36, B = {B}, "
            f"bf16)")
    return out


def small_decode(np, dev, code, s, ch, n, expect_tables):
    """Kernels on the card vs plain passes on the CPU, float32 messages."""
    from ldpc_decoder_tpu_torch.runtime.datagen import create_data
    from ldpc_decoder_tpu_torch.runtime.decoder import LDPCDecoder
    from ldpc_decoder_tpu_torch.runtime.params import (
        DynamicParams,
        StaticParams,
    )

    batch = create_data(code, ch, 0, n, backend="numpy")
    dyn = DynamicParams(num_iter_max=60, num_iter_check_parity=5)
    got = {}
    for d in ("cpu", dev):
        dec = LDPCDecoder(code, ch, StaticParams(parallel_factor_user=32),
                          qc=s, device=d)
        assert isinstance(dec.tables, expect_tables), type(dec.tables)
        got[str(d)] = dec.decode(dyn, n, batch.values, batch.syndromes)
    (res_c, st_c), (res_g, st_g) = got["cpu"], got[str(dev)]
    assert res_g.shape == (n, dec.n_words)
    assert np.array_equal(res_g, res_c), "card and CPU decoded words differ"
    assert np.array_equal(res_g, batch.ref_bits_packed()), "bit errors"
    log(f"  small code (n = {code.n_vars}, {n} frames, f32, "
        f"{expect_tables.__name__}): card == CPU == reference bits; avg "
        f"iterations card {st_g.avg_iter:.2f}, CPU {st_c.avg_iter:.2f}, "
        f"per-frame equal: {np.array_equal(st_g.iterations, st_c.iterations)}")
    assert abs(st_g.avg_iter - st_c.avg_iter) <= 5


def run_path(dec, dyn, batch, n, kernels, label, repeat=True, ref=None,
             gate=True):
    """Decode ``n`` frames (twice when ``repeat``, to equal words; the last
    is reported) with the launch counts set to 0 just before the reported
    decode and read just after; every kernel in ``kernels`` must have
    launched and every other kernel not. ``ref``: the batch's packed
    reference bits, when already computed. ``gate``: FER 0 and BER 0 are
    required (else only recorded). Returns (stats, launches)."""
    import numpy as np

    from ldpc_decoder_tpu_torch.ops import _kernels

    first = None
    if repeat:
        t0 = time.perf_counter()
        first, _ = dec.decode(dyn, n, batch.values, batch.syndromes)
        log(f"  {label} decode 1: {time.perf_counter() - t0:.2f} s wall")
    _kernels.reset_launch_counts()
    results, stats = dec.decode(dyn, n, batch.values, batch.syndromes)
    launches = dict(_kernels.launch_counts)
    assert results.shape == (n, dec.n_words)
    if first is not None:
        assert np.array_equal(first, results), \
            f"{label}: the two decodes' words differ"
    if ref is None:
        ref = batch.ref_bits_packed()
    errors = popcount_rows(ref ^ results)
    frame_bits = dec.code.n_vars
    itpv = stats.iter_time_per_vector
    dec_mbps = frame_bits / (stats.avg_iter * itpv * 1048576.0)
    e2e_mbps = (frame_bits * n / 1048576.0) / stats.elapsed_seconds
    fer1, fer15 = float((errors > 0).mean()), float((errors > 15).mean())
    ber = float(errors.sum()) / (frame_bits * n)
    log(f"  {label}: {stats.elapsed_seconds:.3f} s, B = "
        f"{dec.parallel_factor()}, {stats.total_supersteps} supersteps, "
        f"{stats.total_iterations} iterations")
    log(f"  FER(>0) {fer1} ({int((errors > 0).sum())}/{n}), FER(>15) "
        f"{fer15}, BER {ber:.3e}; iterations avg {stats.avg_iter:.2f} min "
        f"{stats.min_iter} max {stats.max_iter}")
    log(f"  itpv {itpv:.4e} s; decoding {dec_mbps:.2f} Mb/s, end-to-end "
        f"{e2e_mbps:.2f} Mb/s; launches {launches}")
    for name, count in launches.items():
        if name in kernels:
            assert count > 0, f"{name} kernel never launched"
        else:
            assert count == 0, f"{name} kernel launched off its path"
    if gate:
        assert fer1 == 0.0 and ber == 0.0, f"FER(>0) = {fer1}, BER = {ber}"
    return stats, launches


def general_lane_state(torch, np, dev, t, ch, batch, B, dtype):
    """The first B frames of ``batch`` as sorted llr [n_vars, B] in the
    LLR-state dtype of ``dtype`` messages and syndromes [n_checks, B] on
    the card."""
    from ldpc_decoder_tpu_torch.ops.general import llr_dtype

    vals = torch.from_numpy(np.ascontiguousarray(
        batch.values[t.vn_order.cpu().numpy(), :B])).to(dev)
    llr = ch.llr_from_channel(vals).masked_fill(
        t.erased_mask_sorted, 0.0).to(llr_dtype(dtype))
    syn = torch.from_numpy(np.ascontiguousarray(
        batch.syndromes[t.cn_order.cpu().numpy(), :B])).to(dev)
    return llr, syn


def phase_general_kernels(torch, np, dev, cc, batch):
    """Each general kernel vs its plain version at full width on a real
    decode state (four iterations in): sum-product bf16 at B = 384 (the
    sum-product path's), int8 min-sum at B = 768 (the min-sum path's) and
    bf16 min-sum at B = 384. Sum-product within the one-ulp share, min-sum
    bitwise; signs and hard bits exact."""
    from ldpc_decoder_tpu_torch.channels import BIAWGNChannel
    from ldpc_decoder_tpu_torch.ops import general as G
    from ldpc_decoder_tpu_torch.runtime import perf

    t = G.GeneralTables.from_compiled(cc, dev)
    ch = BIAWGNChannel(GENERAL_SIGMA)
    E, nv = t.n_edges, t.n_vars
    ms = dict(alpha=0.8, beta=0.0, clamp=64.0, qscale=4.0)
    out = {}
    for label, alg, dtype, B in [
            ("sum-product", "sum-product", torch.bfloat16, 384),
            ("min-sum", "min-sum", torch.int8, 768),
            ("min-sum", "min-sum", torch.bfloat16, 384)]:
        tag = f"{label}, {str(dtype)[6:]}, B = {B}"
        log(f"  {tag}:")
        llr, syn = general_lane_state(torch, np, dev, t, ch, batch, B, dtype)
        kw = dict(alg=alg, **ms) if alg == "min-sum" else {}
        init_kw = {k: kw[k] for k in ("alg", "clamp", "qscale") if k in kw}
        msgs = G.init_messages_general(llr, t, dtype, **init_kw)
        msgs, _, _ = G.run_iterations_general(msgs, llr, syn, t, 4, **kw)
        mv, rc = msgs
        if alg == "min-sum":
            def cn(impl, r):
                return impl(mv, syn, r, t, ms["alpha"], ms["beta"],
                            ms["qscale"])

            def vn(impl, m, bits=None):
                return impl(rc, llr, m, t, ms["clamp"], ms["qscale"],
                            bits=bits)

            cnk, cnp = G.cn_pass_general_minsum, G.cn_pass_general_minsum_plain
            vnk, vnp = G.vn_pass_general_minsum, G.vn_pass_general_minsum_plain
            ops = OPS_PER_MINSUM_MESSAGE
        else:
            def cn(impl, r):
                return impl(mv, syn, r, t)

            def vn(impl, m, bits=None):
                return impl(rc, llr, m, t, bits=bits)

            cnk, cnp = G.cn_pass_general, G.cn_pass_general_plain
            vnk, vnp = G.vn_pass_general, G.vn_pass_general_plain
            ops = OPS_PER_MESSAGE

        def compare(name, k, p):
            if alg == "min-sum":
                assert bit_identical(k, p), f"{name} ({tag}): not bitwise"
                log(f"  {name}: bitwise equal")
                return float((k.float() - p.float()).abs().max())
            return compare_msgs(name, k, p)

        rk, rp = torch.empty_like(rc), torch.empty_like(rc)
        cn(cnk, rk)
        cn(cnp, rp)
        err_cn = compare("r_c", rk, rp)
        del rp
        errs = []
        mk, mp = torch.empty_like(mv), torch.empty_like(mv)
        for emit in (False, True):
            bk = torch.full((nv, B), -1, dtype=torch.int8, device=dev)
            bp = bk.clone()
            vn(vnk, mk, bk if emit else None)
            vn(vnp, mp, bp if emit else None)
            errs.append(compare(f"msgs_v ({'emit' if emit else 'no emit'})",
                                mk, mp))
            assert torch.equal(bk, bp), f"hard bits differ ({tag})"
        log("  hard bits (emit): equal")
        del mp
        passes = perf.general_bytes(t, B, mv.element_size(),
                                    llr.element_size())
        r = {
            "cn": dict(
                max_abs_err=err_cn,
                ms=cuda_ms(lambda: cn(cnk, rk), 10),
                plain_ms=cuda_ms(lambda: cn(cnp, rk), 3),
                bound=bound(passes["cn"], ops * E * B)),
            "vn": dict(
                max_abs_err=max(errs),
                ms=cuda_ms(lambda: vn(vnk, mk), 10),
                plain_ms=cuda_ms(lambda: vn(vnp, mk), 3),
                bound=bound(passes["vn"], ops * E * B)),
        }
        for name, v in r.items():
            log(f"  {name}: kernel {v['ms']:.3f} ms per pass, plain "
                f"{v['plain_ms']:.3f} ms, bound {v['bound'][0]:.3f} ms "
                f"({v['bound'][1]}) (general, {tag})")
        suffix = "_minsum" if alg == "min-sum" else ""
        if f"cn_general{suffix}" not in out:  # the main paths' shapes
            out[f"cn_general{suffix}"] = r["cn"]
            out[f"vn_general{suffix}"] = r["vn"]
        del mv, rc, rk, mk, msgs, llr, syn
        torch.cuda.empty_cache()
    return out


def small_general_decode(np, dev):
    """A multi-bucket irregular code with degree-1 variables: kernels on
    the card vs plain passes on the CPU, f32 sum-product and int8 min-sum
    with a per-degree alpha table; equal words and per-frame iterations.
    (Degree-1 variables leave some frames in error at any noise; the card
    and the CPU must agree on them too.)"""
    from ldpc_decoder_tpu_torch.channels import BIAWGNChannel
    from ldpc_decoder_tpu_torch.codes.generate import make_irregular_code
    from ldpc_decoder_tpu_torch.ops.general import GeneralTables
    from ldpc_decoder_tpu_torch.runtime.datagen import create_data
    from ldpc_decoder_tpu_torch.runtime.decoder import LDPCDecoder
    from ldpc_decoder_tpu_torch.runtime.params import (
        DynamicParams,
        StaticParams,
    )

    code = make_irregular_code(2000, 1000, {1: 0.05, 2: 0.35, 3: 0.4,
                                            4: 0.2}, {5: 0.5, 6: 0.5},
                               seed=3)
    ch = BIAWGNChannel(0.65)
    n = 104
    batch = create_data(code, ch, 0, n, backend="numpy")
    dyn = DynamicParams(num_iter_max=60, num_iter_check_parity=5)
    for kw in (dict(message_dtype="float32"),
               dict(message_dtype="int8", algorithm="min-sum",
                    minsum_alpha={5: 0.8, 6: 0.75}, minsum_offset=0.0)):
        got = {}
        for d in ("cpu", dev):
            dec = LDPCDecoder(code, ch, StaticParams(
                parallel_factor_user=32, qc_autodetect=False, **kw), device=d)
            assert isinstance(dec.tables, GeneralTables)
            got[str(d)] = dec.decode(dyn, n, batch.values, batch.syndromes)
        (res_c, st_c), (res_g, st_g) = got["cpu"], got[str(dev)]
        assert np.array_equal(res_g, res_c), "card and CPU words differ"
        assert np.array_equal(st_g.iterations, st_c.iterations), \
            "card and CPU per-frame iterations differ"
        bad = int((popcount_rows(batch.ref_bits_packed() ^ res_g) > 0).sum())
        log(f"  irregular n = {code.n_vars} (degree-1..4 variables), {n} "
            f"frames, {kw['message_dtype']} "
            f"{kw.get('algorithm', 'sum-product')}: card == CPU words and "
            f"per-frame iterations; avg iterations {st_g.avg_iter:.2f}, "
            f"{bad} frames with bit errors")


def minsum_kernels(torch, np, dev, family, t, llr, syn, B, dtype, alpha,
                   label):
    """One QC family's min-sum kernels against their plain versions on a
    real decode state (four iterations in), offset 0.5, clamp 64, scale 4:
    bitwise, with and without fresh lanes, every group (the grouped
    family's emit and first-after-refill passes run its degree-1 group).
    Returns {"cn": ..., "vn": ...} with the kernel, plain and bound times
    of a non-emit pass."""
    from ldpc_decoder_tpu_torch.ops import qc_grouped as qg
    from ldpc_decoder_tpu_torch.ops import qc_regular as qr
    from ldpc_decoder_tpu_torch.runtime import perf

    beta, clamp, qscale = 0.5, 64.0, 4.0
    ms = dict(alg="min-sum", beta=beta, clamp=clamp, alpha=alpha,
              qscale=qscale)
    if family == "grouped":
        msgs = qg.init_messages_qc_grouped(llr, t, dtype, alg="min-sum",
                                           clamp=clamp, qscale=qscale)
        msgs, _, _ = qg.run_iterations_qc_grouped(msgs, llr, syn, t, 4, **ms)

        def cn(impl, r):
            return impl(mv, syn, r, t, alpha, beta, qscale)

        def vn(impl, m, bits=None, fresh=None, d1=False):
            return impl(rc, llr, m, t, clamp, qscale, bits=bits, fresh=fresh,
                        include_d1=d1)

        cnk, cnp = qg.cn_pass_grouped_minsum, qg.cn_pass_minsum_plain
        vnk, vnp = qg.vn_pass_grouped_minsum, qg.vn_pass_minsum_plain
        run_blocks = sum(g.count * g.degree for g in t.col_groups
                         if g.degree > 1)  # non-emit pass
        count = perf.grouped_bytes
    else:
        msgs = qr.init_messages_qc_regular(llr, t, dtype, alg="min-sum")
        msgs, _, _ = qr.run_iterations_qc_regular(msgs, llr, syn, t, 4, **ms)

        def cn(impl, r):
            return impl(mv, syn, r, t, alpha, beta)

        def vn(impl, m, bits=None, fresh=None, d1=False):
            return impl(rc, llr, m, t, clamp, bits=bits, fresh=fresh)

        cnk, cnp = qr.cn_pass_regular_minsum, qr.cn_pass_minsum_plain
        vnk, vnp = qr.vn_pass_regular_minsum, qr.vn_pass_minsum_plain
        run_blocks = t.n_edges // t.Z
        count = perf.regular_bytes
    mv, rc = msgs
    fresh = torch.zeros(B, dtype=torch.bool, device=dev)
    fresh[::5] = True
    Z, blocks = t.Z, t.n_edges // t.Z

    rk, rp = torch.empty_like(rc), torch.empty_like(rc)
    cn(cnk, rk)
    cn(cnp, rp)
    assert bit_identical(rk, rp), f"r_c ({label}): not bitwise"
    err_cn = float((rk.float() - rp.float()).abs().max())
    del rp
    log("  r_c: bitwise equal")
    mk, mp = mv.clone(), mv.clone()
    for what, emit, fr, d1 in [("plain iteration", False, None, False),
                               ("emit + fresh lanes", True, fresh, False),
                               ("first after refill", False, fresh, True)]:
        mk.copy_(mv)
        mp.copy_(mv)
        bk = torch.full((t.C, Z, B), -1, dtype=torch.int8, device=dev)
        bp = bk.clone()
        vn(vnk, mk, bk if emit else None, fr, d1)
        vn(vnp, mp, bp if emit else None, fr, d1)
        assert bit_identical(mk, mp), f"msgs_v ({label}, {what}): not bitwise"
        assert torch.equal(bk, bp), f"hard bits differ ({label}, {what})"
        log(f"  msgs_v ({what}): bitwise equal"
            + ("; hard bits equal" if emit else ""))
    err_vn = float((mk.float() - mp.float()).abs().max())
    del mp
    passes = count(t, B, mv.element_size(), llr.element_size())
    out = {
        "cn": dict(
            max_abs_err=err_cn,
            ms=cuda_ms(lambda: cn(cnk, rk), 10),
            plain_ms=cuda_ms(lambda: cn(cnp, rk), 3),
            bound=bound(passes["cn"],
                        OPS_PER_MINSUM_MESSAGE * blocks * Z * B)),
        "vn": dict(
            max_abs_err=err_vn,
            ms=cuda_ms(lambda: vn(vnk, mk), 10),
            plain_ms=cuda_ms(lambda: vn(vnp, mk), 3),
            bound=bound(passes["vn"],
                        OPS_PER_MINSUM_MESSAGE * run_blocks * Z * B)),
    }
    for name, r in out.items():
        log(f"  {name}: kernel {r['ms']:.3f} ms per pass, plain "
            f"{r['plain_ms']:.3f} ms, bound {r['bound'][0]:.3f} ms "
            f"({r['bound'][1]}) ({label})")
    return out


def minsum_lane_state(torch, np, dev, t, ch, batch, B, dtype):
    """lane_state with the llr in the LLR-state dtype of ``dtype``."""
    from ldpc_decoder_tpu_torch.ops.qc_decode import llr_dtype

    llr, syn = lane_state(torch, np, dev, t, ch, batch, B)
    return llr.to(llr_dtype(dtype)), syn


def phase_p41_minsum_kernels(torch, np, dev, code, s, batch):
    from ldpc_decoder_tpu_torch.channels import BIAWGNChannel
    from ldpc_decoder_tpu_torch.ops import qc_grouped as qg
    from ldpc_decoder_tpu_torch.ops.qc_decode import QCDecodeTables

    t = qg.GroupedQCTables.from_qc_tables(
        QCDecodeTables.from_structure(s, code.n_erased_vars, dev))
    assert t.col_groups[0].degree == 1
    B = 256
    llr, syn = minsum_lane_state(torch, np, dev, t, BIAWGNChannel(SIGMA),
                                 batch, B, torch.int8)
    return minsum_kernels(torch, np, dev, "grouped", t, llr, syn, B,
                          torch.int8, tuple(MINSUM_ALPHA_TABLE.items()),
                          "p41, B = 256, int8, alpha table")


def phase_reg36_minsum_kernels(torch, np, dev, code, s, batch):
    from ldpc_decoder_tpu_torch.channels import BIAWGNChannel
    from ldpc_decoder_tpu_torch.ops import qc_grouped as qg
    from ldpc_decoder_tpu_torch.ops import qc_regular as qr
    from ldpc_decoder_tpu_torch.ops.qc_decode import QCDecodeTables

    qct = QCDecodeTables.from_structure(s, code.n_erased_vars, dev)
    ch, B, out = BIAWGNChannel(MINSUM_SIGMA), 256, {}
    t = qr.QCRegularTables.from_qc_tables(qct)
    log("  regular family, bf16:")
    llr, syn = minsum_lane_state(torch, np, dev, t, ch, batch, B,
                                 torch.bfloat16)
    r = minsum_kernels(torch, np, dev, "regular", t, llr, syn, B,
                       torch.bfloat16, 1.0, "reg36, B = 256, bf16")
    out["cn_regular_minsum"], out["vn_regular_minsum"] = r["cn"], r["vn"]
    del llr, syn, r
    torch.cuda.empty_cache()
    t = qg.GroupedQCTables.from_qc_tables(qct)
    log("  grouped family, int8:")
    llr, syn = minsum_lane_state(torch, np, dev, t, ch, batch, B, torch.int8)
    r = minsum_kernels(torch, np, dev, "grouped", t, llr, syn, B, torch.int8,
                       1.0, "reg36, B = 256, int8")
    out["cn_group_minsum"], out["vn_group_minsum"] = r["cn"], r["vn"]
    return out


def card_vs_cpu_decodes(np, dev, cases):
    """Kernels on the card vs plain passes on the CPU, 104 frames at B = 32
    (refills) per case (label, code, sigma, StaticParams fields, tables
    class); equal words and per-frame iterations."""
    from ldpc_decoder_tpu_torch.channels import BIAWGNChannel
    from ldpc_decoder_tpu_torch.runtime.datagen import create_data
    from ldpc_decoder_tpu_torch.runtime.decoder import LDPCDecoder
    from ldpc_decoder_tpu_torch.runtime.params import (
        DynamicParams,
        StaticParams,
    )

    n = 104
    dyn = DynamicParams(num_iter_max=60, num_iter_check_parity=5)
    for label, code, sigma, kw, want in cases:
        ch = BIAWGNChannel(sigma)
        batch = create_data(code, ch, 0, n, backend="numpy")
        got = {}
        for d in ("cpu", dev):
            dec = LDPCDecoder(code, ch, StaticParams(
                parallel_factor_user=32, **kw), device=d)
            assert isinstance(dec.tables, want), type(dec.tables)
            got[str(d)] = dec.decode(dyn, n, batch.values, batch.syndromes)
        (res_c, st_c), (res_g, st_g) = got["cpu"], got[str(dev)]
        assert np.array_equal(res_g, res_c), f"{label}: words differ"
        assert np.array_equal(st_g.iterations, st_c.iterations), \
            f"{label}: per-frame iterations differ"
        bad = int((popcount_rows(batch.ref_bits_packed() ^ res_g) > 0).sum())
        log(f"  {label} ({want.__name__}): card == CPU words and per-frame "
            f"iterations; avg iterations {st_g.avg_iter:.2f}, "
            f"{st_g.total_supersteps} supersteps, {bad} of {n} frames with "
            f"bit errors")


def small_qc_minsum_decodes(np, dev):
    """QC min-sum from plain codes (detection on), card vs CPU."""
    from ldpc_decoder_tpu_torch.codes.protographs import p41_code
    from ldpc_decoder_tpu_torch.codes.qc import make_qc_code
    from ldpc_decoder_tpu_torch.ops.qc_grouped import GroupedQCTables
    from ldpc_decoder_tpu_torch.ops.qc_regular import QCRegularTables

    reg, _ = make_qc_code(np.ones((3, 6), np.int8), Z=128, seed=1)
    p41, _ = p41_code(Z=128, m=4, coarse=64, fine_mod=16)
    ms = dict(algorithm="min-sum")
    card_vs_cpu_decodes(np, dev, [
        ("regular (3,6), bf16", reg, 0.8, dict(ms, message_dtype="bfloat16"),
         QCRegularTables),
        ("regular (3,6), int8", reg, 0.8, dict(ms, message_dtype="int8"),
         GroupedQCTables),
        ("p41 Z = 128, int8, alpha table", p41, 0.7, dict(
            ms, message_dtype="int8", minsum_offset=0.0,
            minsum_alpha=MINSUM_ALPHA_TABLE), GroupedQCTables),
    ])


def detection_decodes(np, dev):
    """A small aligned QC code and its interleaved renumbering decode the
    same frames to the same words on the card (sum-product f32 and int8
    min-sum); a random code takes the general path."""
    from ldpc_decoder_tpu_torch.channels import BIAWGNChannel
    from ldpc_decoder_tpu_torch.codes.generate import make_regular_code
    from ldpc_decoder_tpu_torch.codes.protographs import regular_base
    from ldpc_decoder_tpu_torch.codes.qc import (
        interleave_code_numbering,
        make_qc_code,
    )
    from ldpc_decoder_tpu_torch.ops.general import GeneralTables
    from ldpc_decoder_tpu_torch.runtime.datagen import create_data
    from ldpc_decoder_tpu_torch.runtime.decoder import LDPCDecoder
    from ldpc_decoder_tpu_torch.runtime.params import (
        DynamicParams,
        StaticParams,
    )

    Z = 256
    code, _ = make_qc_code(regular_base(4, 8, 3, 6, seed=5), Z=Z, seed=2,
                           coarse=64, fine_mod=16, min_girth=0)
    icode, to_v, to_c = interleave_code_numbering(code, Z)
    ch = BIAWGNChannel(0.72)
    n = 104
    batch = create_data(code, ch, 0, n, backend="numpy")
    vals_i = np.empty_like(batch.values)
    vals_i[to_v] = batch.values
    syn_i = np.empty_like(batch.syndromes)
    syn_i[to_c] = batch.syndromes
    dyn = DynamicParams(num_iter_max=60, num_iter_check_parity=5)

    def unpack(res):
        return np.unpackbits(res.view(np.uint8), bitorder="little",
                             axis=1)[:, :code.n_vars]

    for kw in (dict(), dict(algorithm="min-sum", message_dtype="int8")):
        sp = StaticParams(parallel_factor_user=32, **kw)
        dec_a = LDPCDecoder(code, ch, sp)
        dec_i = LDPCDecoder(icode, ch, sp)
        assert dec_a.qc.Z == dec_i.qc.Z == Z
        assert type(dec_a.tables) is type(dec_i.tables)
        assert dec_i._block_perm is None  # packing gathers rows
        res_a, st_a = dec_a.decode(dyn, n, batch.values, batch.syndromes)
        res_i, st_i = dec_i.decode(dyn, n, vals_i, syn_i)
        assert np.array_equal(unpack(res_i)[:, to_v], unpack(res_a)), \
            "interleaved words differ"
        assert np.array_equal(st_i.iterations, st_a.iterations)
        bad = int((popcount_rows(batch.ref_bits_packed() ^ res_a) > 0).sum())
        log(f"  {kw.get('message_dtype', 'float32')} "
            f"{kw.get('algorithm', 'sum-product')} "
            f"({type(dec_a.tables).__name__}): interleaved == aligned words "
            f"and per-frame iterations ({bad} of {n} frames with bit "
            f"errors); detection {dec_a.detect_seconds * 1e3:.1f} ms "
            f"aligned, {dec_i.detect_seconds * 1e3:.1f} ms interleaved")
    rnd = make_regular_code(4096, 3, 6, seed=3)
    dec = LDPCDecoder(rnd, ch, StaticParams(parallel_factor_user=32))
    assert dec.qc is None and isinstance(dec.tables, GeneralTables)
    log(f"  random (3,6) n = 4096: general path; detection "
        f"{dec.detect_seconds * 1e3:.1f} ms")


def qc_minsum_path(dec, dyn, batch, n, kernels, label, s_expect, want, ref):
    """A reg36 min-sum path from the plain code: the detected structure is
    the construction's, the family ``want``; then run_path (``ref``: the
    packed reference bits)."""
    assert dec.device.type == "cuda" and dec.parallel_factor() == 256
    assert isinstance(dec.tables, want), type(dec.tables)
    for f in ("edge_row", "edge_col", "edge_shift"):
        assert (getattr(dec.qc, f) == getattr(s_expect, f)).all(), f
    log(f"  {label}: detected Z = {dec.qc.Z} ({dec.qc.n_base_rows} x "
        f"{dec.qc.n_base_cols} base) in {dec.detect_seconds:.3f} s, "
        f"{want.__name__}")
    stats, launches = run_path(dec, dyn, batch, n, kernels, label, ref=ref)
    lo, hi = MINSUM_AVG_ITERS
    assert lo <= stats.avg_iter <= hi, stats.avg_iter
    return stats, launches


def fp8_sum_product_kernels(torch, np, dev, family, t, llr, syn, B, label):
    """One QC family's float8_e5m2 sum-product kernels against their plain
    versions on a real decode state (four iterations in): every group,
    with and without fresh lanes and emits; messages within
    perf.FP8_STEP_SHARE, hard bits exact. Returns {"cn": ..., "vn": ...} with
    the kernel, plain and bound times of a non-emit pass."""
    from ldpc_decoder_tpu_torch.ops import qc_grouped as qg
    from ldpc_decoder_tpu_torch.ops import qc_regular as qr
    from ldpc_decoder_tpu_torch.runtime import perf

    fp8 = torch.float8_e5m2
    if family == "grouped":
        mod, cnk, vnk = qg, qg.cn_pass_grouped, qg.vn_pass_grouped
        msgs = qg.init_messages_qc_grouped(llr, t, fp8)
        msgs, _, _ = qg.run_iterations_qc_grouped(msgs, llr, syn, t, 4)
        run_blocks = sum(g.count * g.degree for g in t.col_groups
                         if g.degree > 1)  # non-emit pass
        passes = perf.grouped_bytes(t, B, 1, 2)  # e5m2 messages, bf16 llr
        after_refill = {"include_d1": True}
    else:
        mod, cnk, vnk = qr, qr.cn_pass_regular, qr.vn_pass_regular
        msgs = qr.init_messages_qc_regular(llr, t, fp8)
        msgs, _, _ = qr.run_iterations_qc_regular(msgs, llr, syn, t, 4)
        run_blocks = t.n_edges // t.Z
        passes = perf.regular_bytes(t, B, 1, 2)
        after_refill = {}
    mv, rc = msgs
    Z, blocks = t.Z, t.n_edges // t.Z
    fresh = torch.zeros(B, dtype=torch.bool, device=dev)
    fresh[::5] = True

    rk, rp = torch.empty_like(rc), torch.empty_like(rc)
    cnk(mv, syn, rk, t)
    mod.cn_pass_plain(mv, syn, rp, t)
    err_cn = compare_msgs("r_c", rk, rp)
    del rp
    errs = []
    mk, mp = mv.clone(), mv.clone()
    for what, emit, fr, kw in [("plain iteration", False, None, {}),
                               ("emit + fresh lanes", True, fresh, {}),
                               ("first after refill", False, fresh,
                                after_refill)]:
        mk.copy_(mv)
        mp.copy_(mv)
        bk = torch.full((t.C, Z, B), -1, dtype=torch.int8, device=dev)
        bp = bk.clone()
        vnk(rk, llr, mk, t, bits=bk if emit else None, fresh=fr, **kw)
        mod.vn_pass_plain(rk, llr, mp, t, bits=bp if emit else None,
                          fresh=fr, **kw)
        errs.append(compare_msgs(f"msgs_v ({what})", mk, mp))
        assert torch.equal(bk, bp), f"hard bits differ ({label}, {what})"
    del mp
    out = {
        "cn": dict(
            max_abs_err=err_cn,
            ms=cuda_ms(lambda: cnk(mv, syn, rk, t), 10),
            plain_ms=cuda_ms(lambda: mod.cn_pass_plain(mv, syn, rk, t), 3),
            bound=bound(passes["cn"], OPS_PER_MESSAGE * blocks * Z * B)),
        "vn": dict(
            max_abs_err=max(errs),
            ms=cuda_ms(lambda: vnk(rk, llr, mk, t), 10),
            plain_ms=cuda_ms(lambda: mod.vn_pass_plain(rk, llr, mk, t), 3),
            bound=bound(passes["vn"], OPS_PER_MESSAGE * run_blocks * Z * B)),
    }
    for name, r in out.items():
        log(f"  {name}: kernel {r['ms']:.3f} ms per pass, plain "
            f"{r['plain_ms']:.3f} ms, bound {r['bound'][0]:.3f} ms "
            f"({r['bound'][1]}) ({label})")
    return out


def phase_fp8_kernels(torch, np, dev, code, s, batch, code36, s36, batch36):
    """The float8_e5m2 kernels of both QC families against their plain
    versions at full width: sum-product and min-sum (offset 0.5; the
    p41 one with the alpha table) at reg36 and p41 x B = 256."""
    from ldpc_decoder_tpu_torch.channels import BIAWGNChannel
    from ldpc_decoder_tpu_torch.ops import qc_grouped as qg
    from ldpc_decoder_tpu_torch.ops import qc_regular as qr
    from ldpc_decoder_tpu_torch.ops.qc_decode import QCDecodeTables

    fp8, B, out = torch.float8_e5m2, 256, {}
    t = qr.QCRegularTables.from_qc_tables(
        QCDecodeTables.from_structure(s36, code36.n_erased_vars, dev))
    llr, syn = minsum_lane_state(torch, np, dev, t,
                                 BIAWGNChannel(REG36_SIGMA), batch36, B, fp8)
    log("  regular family, sum-product:")
    r = fp8_sum_product_kernels(torch, np, dev, "regular", t, llr, syn, B,
                                "reg36, B = 256, fp8")
    out["cn_regular_fp8"], out["vn_regular_fp8"] = r["cn"], r["vn"]
    torch.cuda.empty_cache()
    log("  regular family, min-sum:")
    minsum_kernels(torch, np, dev, "regular", t, llr, syn, B, fp8, 1.0,
                   "reg36, B = 256, fp8 min-sum")
    del t, llr, syn
    torch.cuda.empty_cache()
    t = qg.GroupedQCTables.from_qc_tables(
        QCDecodeTables.from_structure(s, code.n_erased_vars, dev))
    llr, syn = minsum_lane_state(torch, np, dev, t, BIAWGNChannel(SIGMA),
                                 batch, B, fp8)
    log("  grouped family, sum-product:")
    r = fp8_sum_product_kernels(torch, np, dev, "grouped", t, llr, syn, B,
                                "p41, B = 256, fp8")
    out["cn_fp8"], out["vn_fp8"] = r["cn"], r["vn"]
    torch.cuda.empty_cache()
    log("  grouped family, min-sum:")
    minsum_kernels(torch, np, dev, "grouped", t, llr, syn, B, fp8,
                   tuple(MINSUM_ALPHA_TABLE.items()),
                   "p41, B = 256, fp8 min-sum, alpha table")
    return out


def small_fp8_decodes(np, dev):
    """float8_e5m2 decodes from plain codes (detection on), card vs CPU."""
    from ldpc_decoder_tpu_torch.codes.protographs import p41_code
    from ldpc_decoder_tpu_torch.codes.qc import make_qc_code
    from ldpc_decoder_tpu_torch.ops.qc_grouped import GroupedQCTables
    from ldpc_decoder_tpu_torch.ops.qc_regular import QCRegularTables

    reg, _ = make_qc_code(np.ones((3, 6), np.int8), Z=128, seed=1)
    p41, _ = p41_code(Z=128, m=4, coarse=64, fine_mod=16)
    fp8 = dict(message_dtype="float8_e5m2")
    card_vs_cpu_decodes(np, dev, [
        ("regular (3,6), fp8 sum-product", reg, 0.7, fp8, QCRegularTables),
        ("p41 Z = 128, fp8 sum-product", p41, 0.7, fp8, GroupedQCTables),
        ("p41 Z = 128, fp8 min-sum", p41, 0.7,
         dict(fp8, algorithm="min-sum"), GroupedQCTables),
    ])


def phase_cli(np):
    """The CLI on reg36 in process (bf16, log level 2), then as a module in
    a subprocess on a small QC code. Returns the reg36 run's figures."""
    import contextlib
    import io

    from ldpc_decoder_tpu_torch import cli
    from ldpc_decoder_tpu_torch.codes.qc import make_qc_code, write_qc_alist

    argv = ["-f", REG36_ALIST, "-c", "1", "-n", str(REG36_SIGMA), "-p", "8",
            "-m", "2", "-e", "15", "-i", "120", "--check-period", "10",
            "--dtype", "bfloat16", "-l", "2"]
    log(f"  cli.main({' '.join(argv)})")
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    wall = time.perf_counter() - t0
    text = buf.getvalue()
    keep = ("Number of vectors", " Test vector", "  bp_", "  parity_",
            "  superstep", "  retire", "  refill", "Iterations (",
            "  total =", "# of frames", "Total # of", "Bit error",
            "Frames with", "Elapsed", "Throughput", "Max/min",
            "Iteration time", "Decoding throughput")
    for line in text.splitlines():
        if line.startswith(keep):
            log(f"  | {line}")
    log(f"  in-process CLI: exit {rc}, {wall:.1f} s wall")
    assert rc == 0, text[-2000:]
    assert "Bit error rate (BER):             0\n" in text
    assert "Frames with at least one error:   0 (" in text
    assert "Phase timings (per call):" in text
    m = re.search(r"Max/min/average number of iterations per vector: "
                  r"(\d+)/(\d+)/([\d.e+-]+)", text)
    avg = float(m.group(3))
    assert REG36_AVG_ITERS[0] <= avg <= REG36_AVG_ITERS[1], avg

    code, s = make_qc_code(np.ones((3, 6), np.int8), Z=128, seed=1)
    write_qc_alist(code, s, CLI_SMALL_ALIST)
    cmd = [sys.executable, "-m", "ldpc_decoder_tpu_torch.cli", "-f",
           CLI_SMALL_ALIST, "-c", "1", "-n", "0.7", "-p", "5", "-m", "2",
           "-e", "15", "-i", "60"]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                       timeout=300)
    log(f"  python3 -m ldpc_decoder_tpu_torch.cli on a (3,6) Z = 128 code: "
        f"exit {r.returncode}, {time.perf_counter() - t0:.1f} s wall")
    assert r.returncode == 0, r.stderr[-2000:]
    assert "Bit error rate (BER):             0\n" in r.stdout
    return {"avg_iter": avg, "wall_s": wall}


def phase_probes(torch, dev, code, s, batch, s36):
    """Every probe kernel mode against its plain version at full size, then
    each probe's headline point with the launch counts set to 0 just before
    it and read just after. Returns the kernels-line entries of rows
    11-16."""
    from ldpc_decoder_tpu_torch import probes
    from ldpc_decoder_tpu_torch.ops import _kernels

    t0 = time.perf_counter()
    errs = probes.check_template_modes(dev)
    torch.cuda.synchronize()
    log(f"  {len(errs)} kernel modes equal their plain versions (max |diff| "
        f"{max(errs.values()):.3e}) in {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    card = probes.card(dev)
    extra = {"noalias": dict(code=code, structure=s, batch=batch),
             "rotated_copy": dict(structure=s36)}
    entries = []
    for name, probe, source, counters in PROBE_ROWS:
        t0 = time.perf_counter()
        _kernels.reset_launch_counts()
        recs = probes.PROBES[probe](dev, headline=True, card=card,
                                    **extra.get(probe, {}))
        torch.cuda.synchronize()
        launches = dict(_kernels.launch_counts)
        for rec in recs:
            log(json.dumps(rec))
        for counter, n in launches.items():
            if counter in counters:
                assert n > 0, f"{probe}: {counter} kernel never launched"
            else:
                assert n == 0, f"{probe}: {counter} launched off its path"
        head = recs[0]
        entries.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": head["replaces"],
            "launches": sum(launches[c] for c in counters),
            "max_abs_err": head["max_abs_err"], "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"]})
        log(f"  {probe}: {head['ms']:.3f} ms, bound {head['bound_ms']:.3f} "
            f"ms ({head['bound_by']}), {entries[-1]['launches']} launches, "
            f"{time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()
    return entries


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    t_all = time.perf_counter()

    phase(1, "device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    smi = smi.strip().splitlines()[0]
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} "
        f"device(s); name and power limit:")
    log(smi)

    phase(2, "build")
    phase_build()

    phase(3, "numerics smoke: phi on the device")
    from ldpc_decoder_tpu_torch.runtime.smoke import cuda_numerics_smoke

    cuda_numerics_smoke(dev, verbose=lambda m: log(f"  {m}"))

    phase(4, "code and frames")
    from ldpc_decoder_tpu_torch import native
    from ldpc_decoder_tpu_torch.channels import (
        BIAWGNChannel,
        ErasureChannel,
    )
    from ldpc_decoder_tpu_torch.ops.qc_grouped import GroupedQCTables
    from ldpc_decoder_tpu_torch.ops.qc_regular import QCRegularTables
    from ldpc_decoder_tpu_torch.runtime.datagen import create_data
    from ldpc_decoder_tpu_torch.runtime.decoder import LDPCDecoder
    from ldpc_decoder_tpu_torch.runtime.params import (
        DynamicParams,
        StaticParams,
    )

    t0 = time.perf_counter()
    code, s, how = get_code()
    log(f"  p41: n = {code.n_vars}, {code.n_erased_vars} punctured, "
        f"{s.n_base_edges} circulants of Z = {s.Z} ({how}, "
        f"{time.perf_counter() - t0:.1f} s)")
    backend = "native" if native.available() else "numpy"
    t0 = time.perf_counter()
    ch = BIAWGNChannel(SIGMA)
    batch = create_data(code, ch, 0, N_FRAMES, backend=backend)
    log(f"  create_data: {N_FRAMES} frames at sigma {SIGMA}, {backend} "
        f"backend, {time.perf_counter() - t0:.1f} s")

    phase(5, "grouped kernels vs plain at p41 x B = 256")
    timings = phase_kernels(torch, np, dev, code, s, batch)
    torch.cuda.empty_cache()

    phase(6, "small p41 decode: card vs CPU")
    from ldpc_decoder_tpu_torch.codes.protographs import p41_code

    small, s_small = p41_code(Z=128, m=4, coarse=64, fine_mod=16)
    small_decode(np, dev, small, s_small, BIAWGNChannel(0.7), 104,
                 GroupedQCTables)

    phase(7, "p41 path")
    sp = StaticParams(max_log_parallel_factor_user=8,
                      message_dtype="bfloat16")
    dec = LDPCDecoder(code, ch, sp, qc=s)
    assert dec.device.type == "cuda" and dec.parallel_factor() == 256
    assert isinstance(dec.tables, GroupedQCTables)
    dyn = DynamicParams(num_iter_max=120, num_iter_check_parity=14,
                        num_iter_first_check=70, loading_factor=2)
    stats, launches = run_path(dec, dyn, batch, N_FRAMES, GROUPED, "p41")
    assert AVG_ITERS[0] <= stats.avg_iter <= AVG_ITERS[1], stats.avg_iter
    del dec  # the frames stay for phase 18
    torch.cuda.empty_cache()

    phase(8, "reg36 code and frames")
    t0 = time.perf_counter()
    code36, s36, how = get_reg36_code()
    log(f"  reg36: n = {code36.n_vars}, {s36.n_base_rows} x "
        f"{s36.n_base_cols} base, {s36.n_base_edges} circulants of Z = "
        f"{s36.Z} ({how}, {time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    ch36 = BIAWGNChannel(REG36_SIGMA)
    batch36 = create_data(code36, ch36, 0, N_FRAMES, backend=backend)
    log(f"  create_data: {N_FRAMES} frames at sigma {REG36_SIGMA}, "
        f"{backend} backend, {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    bec = ErasureChannel(EPSILON)
    batch_bec = create_data(code36, bec, 0, N_ERASURE_FRAMES,
                            backend="numpy")
    log(f"  create_data: {N_ERASURE_FRAMES} frames at epsilon {EPSILON}, "
        f"numpy backend, {time.perf_counter() - t0:.1f} s")

    phase(9, "regular kernels vs plain and grouped at reg36 x B = 256")
    timings.update(phase_regular_kernels(torch, np, dev, code36, s36, batch36))
    torch.cuda.empty_cache()

    phase(10, "small regular decode: card vs CPU")
    from ldpc_decoder_tpu_torch.codes.qc import make_qc_code

    small, s_small = make_qc_code(np.ones((3, 6), np.int8), Z=128, seed=1)
    small_decode(np, dev, small, s_small, BIAWGNChannel(0.7), 104,
                 QCRegularTables)

    phase(11, "reg36 path")
    dec36 = LDPCDecoder(code36, ch36, sp, qc=s36)
    assert dec36.device.type == "cuda" and dec36.parallel_factor() == 256
    assert isinstance(dec36.tables, QCRegularTables)
    dyn36 = DynamicParams(num_iter_max=120, num_iter_check_parity=10,
                          num_iter_first_check=0, loading_factor=2)
    stats36, launches36 = run_path(dec36, dyn36, batch36, N_FRAMES, REGULAR,
                                   "reg36")
    assert REG36_AVG_ITERS[0] <= stats36.avg_iter <= REG36_AVG_ITERS[1], \
        stats36.avg_iter
    del dec36  # the frames stay for phases 25 and 27
    torch.cuda.empty_cache()

    phase(12, "reg36 erasure decode")
    dec_bec = LDPCDecoder(code36, bec, sp, qc=s36)
    stats_bec, _ = run_path(dec_bec, dyn36, batch_bec, N_ERASURE_FRAMES,
                            REGULAR, f"erasure {EPSILON}", repeat=False)
    assert stats_bec.avg_iter <= ERASURE_MAX_AVG_ITERS, stats_bec.avg_iter
    del dec_bec, batch_bec
    torch.cuda.empty_cache()

    phase(13, "general code and frames")
    from ldpc_decoder_tpu_torch.codes.compiled import compile_code
    from ldpc_decoder_tpu_torch.codes.generate import make_regular_code
    from ldpc_decoder_tpu_torch.ops.general import GeneralTables

    t0 = time.perf_counter()
    gcode = make_regular_code(2**20, 3, 6, seed=9)
    t1 = time.perf_counter()
    gcc = compile_code(gcode)
    log(f"  random (3,6) code: n = {gcode.n_vars}, {gcode.n_edges} edges, "
        f"generated in {t1 - t0:.1f} s, compiled in "
        f"{time.perf_counter() - t1:.1f} s")
    t0 = time.perf_counter()
    gch = BIAWGNChannel(GENERAL_SIGMA)
    gbatch = create_data(gcode, gch, 0, N_GENERAL_FRAMES, backend=backend)
    gref = gbatch.ref_bits_packed()
    log(f"  create_data: {N_GENERAL_FRAMES} frames at sigma "
        f"{GENERAL_SIGMA}, {backend} backend, "
        f"{time.perf_counter() - t0:.1f} s")

    phase(14, "general kernels vs plain at full width")
    timings.update(phase_general_kernels(torch, np, dev, gcc, gbatch))

    phase(15, "small general decode: card vs CPU")
    small_general_decode(np, dev)

    phase(16, "general sum-product path")
    gdyn = DynamicParams(num_iter_max=120, num_iter_check_parity=10,
                         num_iter_first_check=0, loading_factor=2)
    gdec = LDPCDecoder(gcc, gch, StaticParams(
        parallel_factor_user=384, message_dtype="bfloat16",
        qc_autodetect=False))
    assert gdec.device.type == "cuda" and isinstance(gdec.tables,
                                                     GeneralTables)
    gstats, glaunches = run_path(gdec, gdyn, gbatch, N_GENERAL_FRAMES,
                                 GENERAL_SP, "general sum-product", ref=gref)
    assert GENERAL_AVG_ITERS[0] <= gstats.avg_iter <= GENERAL_AVG_ITERS[1], \
        gstats.avg_iter
    del gdec
    torch.cuda.empty_cache()

    phase(17, "general int8 min-sum path")
    mdec = LDPCDecoder(gcc, gch, StaticParams(
        parallel_factor_user=768, message_dtype="int8", algorithm="min-sum",
        minsum_alpha=0.8, minsum_offset=0.0, qc_autodetect=False))
    mstats, mlaunches = run_path(mdec, gdyn, gbatch, N_GENERAL_FRAMES,
                                 GENERAL_MS, "general int8 min-sum", ref=gref)
    lo, hi = GENERAL_MINSUM_AVG_ITERS
    assert lo <= mstats.avg_iter <= hi, mstats.avg_iter
    del mdec, gbatch, gcc
    torch.cuda.empty_cache()

    phase(18, "grouped min-sum kernels vs plain at p41 x B = 256, int8")
    phase_p41_minsum_kernels(torch, np, dev, code, s, batch)
    torch.cuda.empty_cache()

    phase(19, "reg36 as a plain code, frames and detection")
    from ldpc_decoder_tpu_torch.codes.code import LDPCCode
    from ldpc_decoder_tpu_torch.codes.qc import interleave_code_numbering

    plain36 = LDPCCode.from_alist_data(code36.to_alist_data())
    t0 = time.perf_counter()
    ch84 = BIAWGNChannel(MINSUM_SIGMA)
    batch84 = create_data(plain36, ch84, 0, N_FRAMES, backend=backend)
    log(f"  create_data: {N_FRAMES} frames at sigma {MINSUM_SIGMA}, "
        f"{backend} backend, {time.perf_counter() - t0:.1f} s")
    sp_bf16 = StaticParams(max_log_parallel_factor_user=8,
                           message_dtype="bfloat16", algorithm="min-sum")
    sp_int8 = StaticParams(max_log_parallel_factor_user=8,
                           message_dtype="int8", algorithm="min-sum")
    ms_bf16 = LDPCDecoder(plain36, ch84, sp_bf16)
    log(f"  reg36 plain: detected Z = {ms_bf16.qc.Z} in "
        f"{ms_bf16.detect_seconds:.3f} s")
    t0 = time.perf_counter()
    icode36, _, _ = interleave_code_numbering(plain36, s36.Z)
    log(f"  interleaved renumbering built in {time.perf_counter() - t0:.1f} s")
    idec = LDPCDecoder(icode36, ch84, sp_int8)
    assert idec.qc.Z == s36.Z and isinstance(idec.tables, GroupedQCTables)
    log(f"  reg36 interleaved: detected Z = {idec.qc.Z} (aligned search, "
        f"then the interleaved one) in {idec.detect_seconds:.3f} s")
    del idec, icode36

    phase(20, "QC min-sum kernels vs plain at reg36 x B = 256")
    timings.update(phase_reg36_minsum_kernels(torch, np, dev, plain36, s36,
                                           batch84))
    torch.cuda.empty_cache()

    phase(21, "small QC min-sum decodes: card vs CPU")
    small_qc_minsum_decodes(np, dev)

    phase(22, "detection: aligned vs interleaved, random code")
    detection_decodes(np, dev)

    phase(23, "reg36 bf16 min-sum path")
    ms_dyn = DynamicParams(num_iter_max=120, num_iter_check_parity=10,
                           num_iter_first_check=0, loading_factor=2)
    ref84 = batch84.ref_bits_packed()
    _, ms_reg_launches = qc_minsum_path(
        ms_bf16, ms_dyn, batch84, N_FRAMES, QC_MS_REGULAR,
        "reg36 bf16 min-sum", s36, QCRegularTables, ref84)
    del ms_bf16
    torch.cuda.empty_cache()

    phase(24, "reg36 int8 min-sum path")
    ms_int8 = LDPCDecoder(plain36, ch84, sp_int8)
    _, ms_grp_launches = qc_minsum_path(
        ms_int8, ms_dyn, batch84, N_FRAMES, QC_MS_GROUPED,
        "reg36 int8 min-sum", s36, GroupedQCTables, ref84)
    del ms_int8, batch84, ref84
    torch.cuda.empty_cache()

    phase(25, "float8_e5m2 kernels vs plain at reg36 and p41 x B = 256")
    timings.update(phase_fp8_kernels(torch, np, dev, code, s, batch, code36,
                                  s36, batch36))
    torch.cuda.empty_cache()

    phase(26, "small float8_e5m2 decodes: card vs CPU")
    small_fp8_decodes(np, dev)

    phase(27, "reg36 float8_e5m2 path")
    sp_fp8 = StaticParams(max_log_parallel_factor_user=8,
                          message_dtype="float8_e5m2")
    dec_fp8 = LDPCDecoder(code36, ch36, sp_fp8, qc=s36)
    assert dec_fp8.parallel_factor() == 256
    assert isinstance(dec_fp8.tables, QCRegularTables)
    stats_fp8, fp8_reg_launches = run_path(dec_fp8, dyn36, batch36, N_FRAMES,
                                           FP8_REGULAR, "reg36 fp8")
    lo, hi = REG36_FP8_AVG_ITERS
    assert lo <= stats_fp8.avg_iter <= hi, stats_fp8.avg_iter
    del dec_fp8, batch36
    torch.cuda.empty_cache()

    phase(28, "p41 float8_e5m2 path (recorded, not gated)")
    dec_fp8 = LDPCDecoder(code, ch, sp_fp8, qc=s)
    assert dec_fp8.parallel_factor() == 256
    assert isinstance(dec_fp8.tables, GroupedQCTables)
    _, fp8_grp_launches = run_path(dec_fp8, dyn, batch, N_FRAMES, FP8_GROUPED,
                                   "p41 fp8", gate=False)
    del dec_fp8  # the frames stay for phase 30
    torch.cuda.empty_cache()

    phase(29, "the CLI")
    phase_cli(np)

    phase(30, "probes (rows 11-16)")
    probe_entries = phase_probes(torch, dev, code, s, batch, s36)
    del batch
    log(f"  all phases passed in {time.perf_counter() - t_all:.1f} s")

    launches.update({name: launches36[name] for name in REGULAR})
    launches.update({name: glaunches[name] for name in GENERAL_SP})
    launches.update({name: mlaunches[name] for name in GENERAL_MS})
    launches.update({name: ms_reg_launches[name]
                     for name in QC_MS_REGULAR[:2]})
    launches.update({name: ms_grp_launches[name]
                     for name in QC_MS_GROUPED[:2]})
    launches.update({name: fp8_reg_launches[name]
                     for name in FP8_REGULAR[:2]})
    launches.update({name: fp8_grp_launches[name]
                     for name in FP8_GROUPED[:2]})
    kernels = []
    for name, source, rep in KERNELS:
        r = timings[name]
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": rep, "launches": launches[name],
                 "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                 "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
                 "bound_by": r["bound"][1], "library_ms": None}
        if "grouped_ms" in r:
            entry["grouped_ms"] = r["grouped_ms"]
        kernels.append(entry)
    kernels += probe_entries
    log(json.dumps({"kernels": kernels}))
    assert "jax" not in sys.modules
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
