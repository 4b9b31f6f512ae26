#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU, and check it.

    python3 chip_smoke.py        # from the repository root, one card

The main path is the bench's flagship decode: the punctured p41 code
(n = 1,032,192, 147,456 punctured), BI-AWGN at sigma = 0.94, sum-product,
bfloat16 messages, B = 256 frames in flight, 512 frames, k = 14, first
parity check at iteration 70, at most 120 iterations; frames generated on
the host and decoded through ``LDPCDecoder.decode``. Phases:

1. device: the card's name and power limit (nvidia-smi);
2. build: the CUDA kernels from ldpc_decoder_tpu_torch/csrc/qc_grouped.cu;
3. phi on the device, through a check-node launch, against float64;
4. the p41 code (alist cache in codes_cache/) and 512 frames on the host;
5. each kernel against its plain PyTorch version on the card, at p41 x
   B = 256 on a real decode state, with both times;
6. a small decode on the card against the plain passes on the CPU;
7. the main path, twice; the second decode is reported, and the kernels'
   launch counts are read around it.

Every phase must pass: any failure raises, and the script exits nonzero
without its result line. The last line of stdout is the result object; the
line before it lists the kernels. Imports nothing of JAX.
"""

import json
import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
P41_ALIST = os.path.join(REPO, "codes_cache",
                         "code_awgn_rate_0.5_thr_0.95.alist")
SIGMA = 0.94
N_FRAMES = 512
# phi on the device vs float64: rel + abs bound (measured on an H100:
# max rel 2.43e-6 near x = 5, so 1e-5 keeps a 4x margin)
PHI_RTOL, PHI_ATOL = 1e-5, 1e-7
# kernel vs plain bf16 messages: share allowed to differ, by one ulp only
BF16_ULP_SHARE = 1e-4
AVG_ITERS = (69.0, 76.0)

KERNELS = [
    ("cn", "ldpc_decoder_tpu/ops/qc_pallas_grouped.py:332"),  # _cn_kernel_g
    ("vn", "ldpc_decoder_tpu/ops/qc_pallas_grouped.py:414"),  # _vn_kernel_g
    ("parity", "ldpc_decoder_tpu/ops/qc_pallas_grouped.py:462"),
]
SOURCE = "ldpc_decoder_tpu_torch/csrc/qc_grouped.cu"


def log(msg):
    print(msg, flush=True)


def get_code():
    """p41 from the alist cache (checked by its #params header), else
    built and cached — the same file and header as bench.py."""
    from ldpc_decoder_tpu_torch.codes.protographs import (
        p41_code,
        p41_shipped_params,
    )
    from ldpc_decoder_tpu_torch.codes.qc import (
        load_qc_alist,
        read_alist_params,
        write_qc_alist,
    )

    want = p41_shipped_params()
    if os.path.exists(P41_ALIST) and read_alist_params(P41_ALIST) == want:
        code, s = load_qc_alist(P41_ALIST)
        if s is not None:
            return code, s, "cache"
    code, s = p41_code()
    os.makedirs(os.path.dirname(P41_ALIST), exist_ok=True)
    write_qc_alist(code, s, P41_ALIST, params=want)
    return code, s, "built"


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


def phase_kernels(torch, np, dev, code, s, batch):
    """Kernel vs plain at the main path's shapes on a real decode state."""
    from ldpc_decoder_tpu_torch.channels import BIAWGNChannel
    from ldpc_decoder_tpu_torch.ops import qc_grouped as qg
    from ldpc_decoder_tpu_torch.ops.qc_decode import QCDecodeTables

    t = qg.GroupedQCTables.from_qc_tables(
        QCDecodeTables.from_structure(s, code.n_erased_vars, dev))
    B = 256
    vals = torch.from_numpy(np.ascontiguousarray(
        batch.values[t.vn_order.cpu().numpy(), :B])).to(dev)
    llr = BIAWGNChannel(SIGMA).llr_from_channel(vals).masked_fill(
        t.erased_mask_sorted, 0.0).to(torch.bfloat16).view(t.C, t.Z, B)
    syn = torch.from_numpy(np.ascontiguousarray(
        batch.syndromes[t.cn_order.cpu().numpy(), :B])).to(dev).view(
        t.R, t.Z, B)
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
    out["cn"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: qg.cn_pass_grouped(mv, syn, rk, t), 10),
        plain_ms=cuda_ms(lambda: qg.cn_pass_plain(mv, syn, rk, t), 3))

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
    out["vn"] = dict(
        max_abs_err=max(errs),
        ms=cuda_ms(lambda: qg.vn_pass_grouped(rk, llr, mk, t), 10),
        plain_ms=cuda_ms(lambda: qg.vn_pass_plain(rk, llr, mk, t), 3))

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
        plain_ms=cuda_ms(lambda: qg.parity_pass_plain(emitted, syn, t), 3))
    for name, r in out.items():
        log(f"  {name}: kernel {r['ms']:.3f} ms per pass, plain "
            f"{r['plain_ms']:.3f} ms (p41, B = {B}, bf16)")
    return out


def phase_small(torch, np, dev):
    """The slice on the small p41-shaped code: kernels on the card vs the
    plain passes on the CPU, float32 messages."""
    from ldpc_decoder_tpu_torch.channels import BIAWGNChannel
    from ldpc_decoder_tpu_torch.codes.protographs import p41_code
    from ldpc_decoder_tpu_torch.runtime.datagen import create_data
    from ldpc_decoder_tpu_torch.runtime.decoder import LDPCDecoder
    from ldpc_decoder_tpu_torch.runtime.params import (
        DynamicParams,
        StaticParams,
    )

    code, s = p41_code(Z=128, m=4, coarse=64, fine_mod=16)
    ch = BIAWGNChannel(0.7)
    n = 104
    batch = create_data(code, ch, 0, n, backend="numpy")
    dyn = DynamicParams(num_iter_max=60, num_iter_check_parity=5)
    got = {}
    for d in ("cpu", dev):
        dec = LDPCDecoder(code, ch, StaticParams(parallel_factor_user=32),
                          qc=s, device=d)
        got[str(d)] = dec.decode(dyn, n, batch.values, batch.syndromes)
    (res_c, st_c), (res_g, st_g) = got["cpu"], got[str(dev)]
    assert res_g.shape == (n, dec.n_words)
    assert np.array_equal(res_g, res_c), "card and CPU decoded words differ"
    assert np.array_equal(res_g, batch.ref_bits_packed()), "bit errors"
    log(f"  small code (n = {code.n_vars}, {n} frames, f32): card == CPU "
        f"== reference bits; avg iterations card {st_g.avg_iter:.2f}, CPU "
        f"{st_c.avg_iter:.2f}, per-frame equal: "
        f"{np.array_equal(st_g.iterations, st_c.iterations)}")
    assert abs(st_g.avg_iter - st_c.avg_iter) <= 5


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    t_all = time.perf_counter()

    log("[1] device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    smi = smi.strip().splitlines()[0]
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} "
        f"device(s); name and power limit:")
    log(smi)

    log("[2] build")
    from ldpc_decoder_tpu_torch.ops import _kernels

    t0 = time.perf_counter()
    lib_path = _kernels.library_path()
    _kernels.load()
    with open(lib_path + ".log") as f:
        ptxas = f.read()
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", ptxas)]
    spills = [int(a) + int(b) for a, b in re.findall(
        r"(\d+) bytes spill stores, (\d+) bytes spill loads", ptxas)]
    log(f"  {SOURCE} -> {os.path.relpath(lib_path, REPO)} in "
        f"{time.perf_counter() - t0:.1f} s; {len(regs)} kernels, max "
        f"{max(regs, default=0)} registers, {sum(spills)} spill bytes")

    log("[3] phi on the device")
    phase_phi(torch, np, dev)

    log("[4] code and frames")
    t0 = time.perf_counter()
    code, s, how = get_code()
    log(f"  p41: n = {code.n_vars}, {code.n_erased_vars} punctured, "
        f"{s.n_base_edges} circulants of Z = {s.Z} ({how}, "
        f"{time.perf_counter() - t0:.1f} s)")
    from ldpc_decoder_tpu_torch import native
    from ldpc_decoder_tpu_torch.channels import BIAWGNChannel
    from ldpc_decoder_tpu_torch.runtime.datagen import create_data

    backend = "native" if native.available() else "numpy"
    t0 = time.perf_counter()
    ch = BIAWGNChannel(SIGMA)
    batch = create_data(code, ch, 0, N_FRAMES, backend=backend)
    log(f"  create_data: {N_FRAMES} frames at sigma {SIGMA}, {backend} "
        f"backend, {time.perf_counter() - t0:.1f} s")

    log("[5] kernels vs plain at p41 x B = 256")
    perf = phase_kernels(torch, np, dev, code, s, batch)
    torch.cuda.empty_cache()

    log("[6] small decode: card vs CPU")
    phase_small(torch, np, dev)

    log("[7] main path")
    from ldpc_decoder_tpu_torch.runtime.decoder import LDPCDecoder
    from ldpc_decoder_tpu_torch.runtime.params import (
        DynamicParams,
        StaticParams,
    )

    dec = LDPCDecoder(code, ch, StaticParams(max_log_parallel_factor_user=8,
                                             message_dtype="bfloat16"),
                      qc=s)
    B = dec.parallel_factor()
    assert dec.device.type == "cuda" and B == 256, (dec.device, B)
    dyn = DynamicParams(num_iter_max=120, num_iter_check_parity=14,
                        num_iter_first_check=70, loading_factor=2)
    t0 = time.perf_counter()
    dec.decode(dyn, N_FRAMES, batch.values, batch.syndromes)
    log(f"  decode 1: {time.perf_counter() - t0:.2f} s wall")
    _kernels.reset_launch_counts()
    results, stats = dec.decode(dyn, N_FRAMES, batch.values,
                                batch.syndromes)
    launches = dict(_kernels.launch_counts)
    assert results.shape == (N_FRAMES, dec.n_words)
    errors = popcount_rows(batch.ref_bits_packed() ^ results)
    frame_bits = code.n_vars
    itpv = stats.iter_time_per_vector
    dec_mbps = frame_bits / (stats.avg_iter * itpv * 1048576.0)
    e2e_mbps = (frame_bits * N_FRAMES / 1048576.0) / stats.elapsed_seconds
    fer1, fer15 = float((errors > 0).mean()), float((errors > 15).mean())
    ber = float(errors.sum()) / (frame_bits * N_FRAMES)
    log(f"  decode 2: {stats.elapsed_seconds:.3f} s, B = {B}, "
        f"{stats.total_supersteps} supersteps, {stats.total_iterations} "
        f"iterations")
    log(f"  FER(>0) {fer1} ({int((errors > 0).sum())}/{N_FRAMES}), "
        f"FER(>15) {fer15}, BER {ber:.3e}; iterations avg "
        f"{stats.avg_iter:.2f} min {stats.min_iter} max {stats.max_iter}")
    log(f"  itpv {itpv:.4e} s; decoding {dec_mbps:.2f} Mb/s, end-to-end "
        f"{e2e_mbps:.2f} Mb/s; launches {launches}")
    for name in launches:
        assert launches[name] > 0, f"{name} kernel never launched"
    assert fer1 == 0.0, f"FER(>0) = {fer1}"
    assert AVG_ITERS[0] <= stats.avg_iter <= AVG_ITERS[1], stats.avg_iter
    log(f"  all phases passed in {time.perf_counter() - t_all:.1f} s")

    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE, "replaces": rep,
         "launches": launches[name],
         "max_abs_err": perf[name]["max_abs_err"],
         "ms": perf[name]["ms"], "plain_ms": perf[name]["plain_ms"]}
        for name, rep in KERNELS]}))
    assert "jax" not in sys.modules
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
