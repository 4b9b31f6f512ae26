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

Phases:

1. device: the card's name and power limit (nvidia-smi);
2. build: the four kernel libraries from ldpc_decoder_tpu_torch/csrc/,
   one nvcc each, started together;
3. phi on the device, through a check-node launch, against float64;
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
24. the reg36 int8 min-sum path, twice, counted the same way.

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
# phi on the device vs float64: rel + abs bound (measured on an H100:
# max rel 2.43e-6 near x = 5, so 1e-5 keeps a 4x margin)
PHI_RTOL, PHI_ATOL = 1e-5, 1e-7
# kernel vs plain bf16 messages: share allowed to differ, by one ulp only
BF16_ULP_SHARE = 1e-4
AVG_ITERS = (69.0, 76.0)         # p41 at sigma 0.94
REG36_AVG_ITERS = (40.0, 45.0)   # reg36 at sigma 0.87, k = 10
ERASURE_MAX_AVG_ITERS = 40.0     # reg36 at epsilon 0.40, k = 10
GENERAL_SIGMA = 0.84
N_GENERAL_FRAMES = 768
GENERAL_AVG_ITERS = (20.0, 30.0)         # sum-product, k = 10
GENERAL_MINSUM_AVG_ITERS = (20.0, 40.0)  # int8 min-sum, k = 10
MINSUM_SIGMA = 0.84     # the README's offset min-sum point on reg36
MINSUM_AVG_ITERS = (20.0, 40.0)  # reg36 offset min-sum, bf16 and int8
# per-degree alpha of the p41 check degrees (3, 6, 7), with the fallback
MINSUM_ALPHA_TABLE = {3: 0.8, 6: 0.75, 7: 0.75, 0: 0.8}
# the card's datasheet peaks (H100 SXM, 700 W): HBM bytes/s and float32
# operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# float32 operations per CN/VN message: |m|, the running sum, the
# leave-one-out subtract, two clamps, x/2, tanh, log, negate (or exp and
# a multiply past 5), the branch select and the sign OR; a parity read is
# one add and one AND
OPS_PER_MESSAGE = 12
OPS_PER_PARITY_READ = 2
# min-sum: |m|, a compare and two selects for the two minima, the leave-
# one-out select, a multiply, a subtract, a max, the sign OR, and the int8
# dequantize/quantize multiply, round and clamp
OPS_PER_MINSUM_MESSAGE = 12

GROUPED_SOURCE = "ldpc_decoder_tpu_torch/csrc/qc_grouped.cu"
REGULAR_SOURCE = "ldpc_decoder_tpu_torch/csrc/qc_regular.cu"
GENERAL_SOURCE = "ldpc_decoder_tpu_torch/csrc/general.cu"
MINSUM_SOURCE = "ldpc_decoder_tpu_torch/csrc/qc_minsum.cu"
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
]
GROUPED = ("cn", "vn", "parity")
REGULAR = ("cn_regular", "vn_regular", "parity_regular")
GENERAL_SP = ("cn_general", "vn_general")
GENERAL_MS = ("cn_general_minsum", "vn_general_minsum")
QC_MS_REGULAR = ("cn_regular_minsum", "vn_regular_minsum", "parity_regular")
QC_MS_GROUPED = ("cn_group_minsum", "vn_group_minsum", "parity")


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


def cuda_ms(fn, reps):
    """Median milliseconds of ``fn()`` over ``reps`` runs (CUDA events)."""
    import torch

    fn()  # warm
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


def bound(n_bytes, n_ops):
    """The least time the card could take: (ms, "bytes" or "operations")."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def popcount_rows(x):
    import numpy as np

    x = np.ascontiguousarray(x, dtype=np.uint32)
    return np.unpackbits(x.view(np.uint8), axis=1).sum(axis=1)


def compare_msgs(name, k, p):
    """Kernel vs plain messages: signs exact; bf16 values equal except a
    share <= BF16_ULP_SHARE one ulp apart (f32: one f32 ulp relative)."""
    import torch

    assert torch.equal(torch.signbit(k), torch.signbit(p)), \
        f"{name}: sign bits differ"
    kf, pf = k.float(), p.float()
    max_abs = float((kf - pf).abs().max())
    if k.dtype == torch.bfloat16:
        ki, pi = k.view(torch.int16).int(), p.view(torch.int16).int()
        diff = (ki - pi).abs()
        share = float((diff != 0).float().mean())
        assert int(diff.max()) <= 1, f"{name}: differs by more than 1 ulp"
        assert share <= BF16_ULP_SHARE, f"{name}: share {share} > limit"
    else:
        share = float((kf != pf).float().mean())
        torch.testing.assert_close(kf, pf, rtol=2.0 ** -22, atol=0)
    log(f"  {name}: {share:.3e} of values differ (max |diff| {max_abs:.3e})")
    return max_abs


def bit_identical(a, b):
    import torch

    if a.dtype.is_floating_point:
        as_int = torch.int16 if a.element_size() == 2 else torch.int32
        return torch.equal(a.reshape(-1).view(as_int),
                           b.reshape(-1).view(as_int))
    return torch.equal(a.reshape(-1), b.reshape(-1))


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


def phase_phi(torch, np, dev):
    """A degree-2 check whose slot 0 carries +0 and slot 1 carries x: the
    kernel writes phi(x + 0 - 0) = phi(x) exactly at slot 0."""
    from ldpc_decoder_tpu_torch.codes.qc import QCStructure
    from ldpc_decoder_tpu_torch.ops import qc_grouped as qg
    from ldpc_decoder_tpu_torch.ops.phi import phi_abs_np
    from ldpc_decoder_tpu_torch.ops.qc_decode import QCDecodeTables

    x = np.concatenate([
        np.logspace(-5, np.log10(80.0), 60000),
        np.linspace(4.99, 5.01, 4001),
        [5.0, np.nextafter(np.float32(5), np.float32(0)),
         np.nextafter(np.float32(5), np.float32(9)), 6.0, 12.0, 25.0,
         50.0, 80.0],
    ]).astype(np.float32)
    Z = x.size
    s = QCStructure(Z=Z, n_base_rows=1, n_base_cols=2,
                    edge_row=np.array([0, 0], np.int32),
                    edge_col=np.array([0, 1], np.int32),
                    edge_shift=np.array([0, 0], np.int32))
    t = qg.GroupedQCTables.from_qc_tables(
        QCDecodeTables.from_structure(s, 0, dev))
    msgs = torch.zeros((2, Z, 1), dtype=torch.float32, device=dev)
    msgs[1, :, 0] = torch.from_numpy(x).to(dev)
    syn = torch.zeros((1, Z, 1), dtype=torch.int8, device=dev)
    r_c = qg.cn_pass_grouped(msgs, syn, torch.empty_like(msgs), t)
    got = r_c[0, :, 0].double().cpu().numpy()
    ref = phi_abs_np(x)
    rel = np.abs(got - ref) / ref
    assert (got > 0).all(), "phi <= 0 on the device"
    ok = np.abs(got - ref) <= PHI_RTOL * ref + PHI_ATOL
    log(f"  phi on the device vs float64 over {Z} points in [1e-5, 80]: "
        f"max rel err {rel.max():.3e} at x={x[rel.argmax()]:.6g} "
        f"(bound rel {PHI_RTOL} + abs {PHI_ATOL}); min phi {got.min():.3e}")
    assert ok.all(), f"phi out of bound at x={x[~ok][:5]}"


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
    msg_bytes = t.nb * t.Z * B * 2
    out["cn"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: qg.cn_pass_grouped(mv, syn, rk, t), 10),
        plain_ms=cuda_ms(lambda: qg.cn_pass_plain(mv, syn, rk, t), 3),
        bound=bound(2 * msg_bytes + t.R * t.Z * B + 8 * t.nb,
                    OPS_PER_MESSAGE * t.nb * t.Z * B))

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
    run = [g for g in t.col_groups if g.degree > 1]
    blocks = sum(g.count * g.degree for g in run)
    cols = sum(g.count for g in run)
    out["vn"] = dict(
        max_abs_err=max(errs),
        ms=cuda_ms(lambda: qg.vn_pass_grouped(rk, llr, mk, t), 10),
        plain_ms=cuda_ms(lambda: qg.vn_pass_plain(rk, llr, mk, t), 3),
        bound=bound((2 * blocks + cols) * t.Z * B * 2 + 8 * blocks,
                    OPS_PER_MESSAGE * blocks * t.Z * B))

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
        bound=bound((t.C + t.R) * t.Z * B + 4 * B + 8 * t.nb,
                    OPS_PER_PARITY_READ * t.nb * t.Z * B))
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
    msg_bytes = t.n_edges * B * 2
    out["cn_regular"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: qr.cn_pass_regular(mv, syn, rk, t), 10),
        plain_ms=cuda_ms(lambda: qr.cn_pass_plain(mv, syn, rk, t), 3),
        grouped_ms=cuda_ms(lambda: qg.cn_pass_grouped(
            mv.view(nb, Z, B), syn, rg, tg), 10),
        bound=bound(2 * msg_bytes + t.n_checks * B + t.cn_read.numel() * 4,
                    OPS_PER_MESSAGE * t.n_edges * B))

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
        bound=bound(2 * msg_bytes + t.n_vars * B * 2
                    + t.vn_read.numel() * 4,
                    OPS_PER_MESSAGE * t.n_edges * B))

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
        bound=bound((t.n_vars + t.n_checks) * B + 4 * B
                    + t.cn_read.numel() * 4,
                    OPS_PER_PARITY_READ * t.n_edges * B))
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


def run_path(dec, dyn, batch, n, kernels, label, repeat=True, ref=None):
    """Decode ``n`` frames (twice when ``repeat``; the last is reported)
    with the launch counts set to 0 just before the reported decode and
    read just after; every kernel in ``kernels`` must have launched and
    every other kernel not. ``ref``: the batch's packed reference bits,
    when already computed. Returns (stats, launches)."""
    from ldpc_decoder_tpu_torch.ops import _kernels

    if repeat:
        t0 = time.perf_counter()
        dec.decode(dyn, n, batch.values, batch.syndromes)
        log(f"  {label} decode 1: {time.perf_counter() - t0:.2f} s wall")
    _kernels.reset_launch_counts()
    results, stats = dec.decode(dyn, n, batch.values, batch.syndromes)
    launches = dict(_kernels.launch_counts)
    assert results.shape == (n, dec.n_words)
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

    t = G.GeneralTables.from_compiled(cc, dev)
    ch = BIAWGNChannel(GENERAL_SIGMA)
    E, nv, nc = t.n_edges, t.n_vars, t.n_checks
    index_bytes = 4 * E  # one slot index per edge
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
        msg_bytes = E * B * mv.element_size()
        llr_bytes = nv * B * llr.element_size()
        r = {
            "cn": dict(
                max_abs_err=err_cn,
                ms=cuda_ms(lambda: cn(cnk, rk), 10),
                plain_ms=cuda_ms(lambda: cn(cnp, rk), 3),
                bound=bound(2 * msg_bytes + nc * B + index_bytes,
                            ops * E * B)),
            "vn": dict(
                max_abs_err=max(errs),
                ms=cuda_ms(lambda: vn(vnk, mk), 10),
                plain_ms=cuda_ms(lambda: vn(vnp, mk), 3),
                bound=bound(2 * msg_bytes + llr_bytes + index_bytes,
                            ops * E * B)),
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
        run = [g for g in t.col_groups if g.degree > 1]  # non-emit pass
        run_blocks = sum(g.count * g.degree for g in run)
        run_cols = sum(g.count for g in run)
        table_bytes = 8 * t.nb
    else:
        msgs = qr.init_messages_qc_regular(llr, t, dtype, alg="min-sum")
        msgs, _, _ = qr.run_iterations_qc_regular(msgs, llr, syn, t, 4, **ms)

        def cn(impl, r):
            return impl(mv, syn, r, t, alpha, beta)

        def vn(impl, m, bits=None, fresh=None, d1=False):
            return impl(rc, llr, m, t, clamp, bits=bits, fresh=fresh)

        cnk, cnp = qr.cn_pass_regular_minsum, qr.cn_pass_minsum_plain
        vnk, vnp = qr.vn_pass_regular_minsum, qr.vn_pass_minsum_plain
        run_blocks, run_cols = t.n_edges // t.Z, t.C
        table_bytes = 4 * t.cn_read.numel()
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
    esize = mv.element_size()
    out = {
        "cn": dict(
            max_abs_err=err_cn,
            ms=cuda_ms(lambda: cn(cnk, rk), 10),
            plain_ms=cuda_ms(lambda: cn(cnp, rk), 3),
            bound=bound(2 * blocks * Z * B * esize + t.R * Z * B
                        + table_bytes,
                        OPS_PER_MINSUM_MESSAGE * blocks * Z * B)),
        "vn": dict(
            max_abs_err=err_vn,
            ms=cuda_ms(lambda: vn(vnk, mk), 10),
            plain_ms=cuda_ms(lambda: vn(vnp, mk), 3),
            bound=bound(2 * run_blocks * Z * B * esize
                        + run_cols * Z * B * llr.element_size()
                        + table_bytes,
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


def small_qc_minsum_decodes(np, dev):
    """QC min-sum from plain codes (detection on): kernels on the card vs
    plain passes on the CPU, 104 frames at B = 32 (refills); equal words
    and per-frame iterations."""
    from ldpc_decoder_tpu_torch.channels import BIAWGNChannel
    from ldpc_decoder_tpu_torch.codes.protographs import p41_code
    from ldpc_decoder_tpu_torch.codes.qc import make_qc_code
    from ldpc_decoder_tpu_torch.ops.qc_grouped import GroupedQCTables
    from ldpc_decoder_tpu_torch.ops.qc_regular import QCRegularTables
    from ldpc_decoder_tpu_torch.runtime.datagen import create_data
    from ldpc_decoder_tpu_torch.runtime.decoder import LDPCDecoder
    from ldpc_decoder_tpu_torch.runtime.params import (
        DynamicParams,
        StaticParams,
    )

    reg, _ = make_qc_code(np.ones((3, 6), np.int8), Z=128, seed=1)
    p41, _ = p41_code(Z=128, m=4, coarse=64, fine_mod=16)
    cases = [
        ("regular (3,6), bf16", reg, 0.8, dict(message_dtype="bfloat16"),
         QCRegularTables),
        ("regular (3,6), int8", reg, 0.8, dict(message_dtype="int8"),
         GroupedQCTables),
        ("p41 Z = 128, int8, alpha table", p41, 0.7, dict(
            message_dtype="int8", minsum_offset=0.0,
            minsum_alpha=MINSUM_ALPHA_TABLE), GroupedQCTables),
    ]
    n = 104
    dyn = DynamicParams(num_iter_max=60, num_iter_check_parity=5)
    for label, code, sigma, kw, want in cases:
        ch = BIAWGNChannel(sigma)
        batch = create_data(code, ch, 0, n, backend="numpy")
        got = {}
        for d in ("cpu", dev):
            dec = LDPCDecoder(code, ch, StaticParams(
                parallel_factor_user=32, algorithm="min-sum", **kw), device=d)
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

    phase(3, "phi on the device")
    phase_phi(torch, np, dev)

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
    perf = phase_kernels(torch, np, dev, code, s, batch)
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
    perf.update(phase_regular_kernels(torch, np, dev, code36, s36, batch36))
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
    del dec36, batch36
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
    perf.update(phase_general_kernels(torch, np, dev, gcc, gbatch))

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
    del batch
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
    perf.update(phase_reg36_minsum_kernels(torch, np, dev, plain36, s36,
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
    log(f"  all phases passed in {time.perf_counter() - t_all:.1f} s")

    launches.update({name: launches36[name] for name in REGULAR})
    launches.update({name: glaunches[name] for name in GENERAL_SP})
    launches.update({name: mlaunches[name] for name in GENERAL_MS})
    launches.update({name: ms_reg_launches[name]
                     for name in QC_MS_REGULAR[:2]})
    launches.update({name: ms_grp_launches[name]
                     for name in QC_MS_GROUPED[:2]})
    kernels = []
    for name, source, rep in KERNELS:
        r = perf[name]
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": rep, "launches": launches[name],
                 "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                 "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
                 "bound_by": r["bound"][1], "library_ms": None}
        if "grouped_ms" in r:
            entry["grouped_ms"] = r["grouped_ms"]
        kernels.append(entry)
    log(json.dumps({"kernels": kernels}))
    assert "jax" not in sys.modules
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
