#!/usr/bin/env python3
"""Where the time goes in the port's decode paths, on one NVIDIA GPU.

    python3 profile_chip.py               # from the repository root, one card
    python3 profile_chip.py p41 "p41 fp8" # only the paths named

For seven paths of ``chip_smoke.py`` with the same decoder settings (p41
at sigma 0.94 and reg36 at sigma 0.87, 512 frames, bf16, B = 256; the
general sum-product path on the random (3,6) 2^20 code at sigma 0.84, 768
frames, bf16, B = 384, and its int8 min-sum path (alpha 0.8, offset 0,
B = 768); reg36 as a plain code, its structure detected, in
int8 offset min-sum at sigma 0.84, 512 frames, B = 256; reg36 and p41 in
float8_e5m2 sum-product at their bf16 settings) it decodes once to warm
up, then profiles a second decode with ``torch.profiler`` (CPU and CUDA
activities) and prints:

- the decode's own clock (``DecodeStats.elapsed_seconds``) under the
  profiler, which covers ``decode_presorted`` on pools already on the
  card, and the host-fed wall time of ``decode()`` (pool permutation and
  upload included) from a third, unprofiled decode;
- device time by kernel name, summed over the profiled decode, with the
  launch counts; the hand-written kernels against the rest (torch's own
  elementwise, copy and indexing kernels);
- the device's busy and idle shares over the span from the profiled
  decode's first device operation to its last (the results readback, which
  ends after the decode's clock stops, included);
- the decoding and end-to-end Mb/s of the unprofiled decode (bench.py's
  formulas, as chip_smoke.py prints them);
- peak device memory, and the card's name, power limit, SM clock and
  power draw read by nvidia-smi after the run.

One JSON object per path goes to stdout, after a readable table; exits
nonzero without a card. Imports nothing of JAX.
"""

import json
import subprocess
import sys
import time

import chip_smoke as cs

# kernel-name fragments of the hand-written kernels (csrc/; the parity
# kernel of both QC families is parity.cuh's parity_kernel)
OWN = ("cn_kernel", "vn_kernel", "parity_kernel", "cn_regular_kernel",
       "vn_regular_kernel", "cn_general_kernel",
       "vn_general_kernel", "cn_general_minsum_kernel",
       "vn_general_minsum_kernel", "cn_group_minsum_kernel",
       "vn_group_minsum_kernel", "cn_regular_minsum_kernel",
       "vn_regular_minsum_kernel")


def device_time_us(evt):
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, attr, None)
        if v is not None:
            return float(v)
    return 0.0


def smi(query):
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]


def profile_path(torch, label, dec, dyn, batch, n):
    from torch.profiler import ProfilerActivity, profile

    dec.decode(dyn, n, batch.values, batch.syndromes)  # warm
    pool_values, pool_syn = dec.upload_pools(batch.values, batch.syndromes)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, stats = dec.decode_presorted(dyn, n, pool_values, pool_syn)
    peak = torch.cuda.max_memory_allocated()
    del pool_values, pool_syn
    t0 = time.perf_counter()
    _, stats_wall = dec.decode(dyn, n, batch.values, batch.syndromes)
    hostfed = time.perf_counter() - t0

    by_name = {}
    for evt in prof.key_averages():
        us = device_time_us(evt)
        if us > 0 and evt.device_type.name == "CUDA":
            by_name[evt.key] = (us, evt.count)
    own = {k: v for k, v in by_name.items() if any(f in k for f in OWN)}
    rest = {k: v for k, v in by_name.items() if k not in own}
    # each template's instantiations summed (degrees, lanes, dtypes, phi)
    by_kernel = {}
    for k, (us, c) in own.items():
        base = next(f for f in sorted(OWN, key=len, reverse=True) if f in k)
        tot = by_kernel.setdefault(base, [0.0, 0])
        tot[0] += us / 1e3
        tot[1] += c
    # bench.py's metrics (chip_smoke.run_path), from the unprofiled decode
    bits = dec.code.n_vars
    itpv = stats_wall.iter_time_per_vector
    busy_us, span_us = cs.busy_and_span_us(prof.events())
    elapsed_ms = stats.elapsed_seconds * 1e3
    out = {
        "path": label, "family": type(dec.tables).__name__,
        "frames": n, "B": dec.parallel_factor(),
        "total_iterations": stats.total_iterations,
        "supersteps": stats.total_supersteps,
        "avg_iter": stats.avg_iter,
        "elapsed_ms_profiled": elapsed_ms,
        "elapsed_ms_unprofiled": stats_wall.elapsed_seconds * 1e3,
        "hostfed_wall_ms": hostfed * 1e3,
        "device_time_by_kernel_total_ms": sum(
            us for us, _ in by_name.values()) / 1e3,
        "device_busy_ms": busy_us / 1e3,
        "device_span_ms": span_us / 1e3,
        "device_idle_share": 1.0 - busy_us / span_us if span_us else 1.0,
        "decoding_mbps": bits / (stats_wall.avg_iter * itpv * 1048576.0),
        "e2e_mbps": bits * n / 1048576.0 / stats_wall.elapsed_seconds,
        "own_by_kernel_ms": {k: tuple(v) for k, v in sorted(
            by_kernel.items(), key=lambda kv: -kv[1][0])},
        "own_kernels_ms": {k: (us / 1e3, c) for k, (us, c) in sorted(
            own.items(), key=lambda kv: -kv[1][0])},
        "other_kernels_ms": sum(us for us, _ in rest.values()) / 1e3,
        "top_other_kernels_ms": {k: (us / 1e3, c) for k, (us, c) in sorted(
            rest.items(), key=lambda kv: -kv[1][0])[:6]},
        "peak_memory_gb": peak / 1e9,
    }
    cs.log(f"[{label}] decode {elapsed_ms:.1f} ms under the profiler "
           f"({out['elapsed_ms_unprofiled']:.1f} ms without; host-fed "
           f"wall {out['hostfed_wall_ms']:.1f} ms); device busy "
           f"{out['device_busy_ms']:.1f} of {out['device_span_ms']:.1f} ms, "
           f"idle share {out['device_idle_share']:.4f}; "
           f"peak memory {out['peak_memory_gb']:.2f} GB; decoding "
           f"{out['decoding_mbps']:.2f} Mb/s, e2e {out['e2e_mbps']:.2f} Mb/s "
           f"(unprofiled)")
    for k, (ms, c) in out["own_by_kernel_ms"].items():
        cs.log(f"  {ms:10.2f} ms  {c:5d} launches  {k} (all instantiations)")
    for k, (ms, c) in out["own_kernels_ms"].items():
        cs.log(f"  {ms:10.2f} ms  {c:5d} launches  {k[:90]}")
    cs.log(f"  {out['other_kernels_ms']:10.2f} ms  other kernels; top: "
           f"{ {k[:50]: v for k, v in out['top_other_kernels_ms'].items()} }")
    return out


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_chip: torch.cuda.is_available() is False; "
                         "this script needs an NVIDIA GPU")
    from ldpc_decoder_tpu_torch.channels import BIAWGNChannel
    from ldpc_decoder_tpu_torch.codes.generate import make_regular_code
    from ldpc_decoder_tpu_torch.ops import _kernels
    from ldpc_decoder_tpu_torch.runtime.datagen import create_data
    from ldpc_decoder_tpu_torch.runtime.decoder import LDPCDecoder
    from ldpc_decoder_tpu_torch.runtime.params import (
        DynamicParams,
        StaticParams,
    )

    cs.log(smi("name,power.limit"))
    for name in _kernels.SOURCES:
        _kernels.load(name)
    sp = StaticParams(max_log_parallel_factor_user=8,
                      message_dtype="bfloat16")
    sp_general = StaticParams(parallel_factor_user=384,
                              message_dtype="bfloat16", qc_autodetect=False)
    sp_general_int8 = StaticParams(
        parallel_factor_user=768, message_dtype="int8", algorithm="min-sum",
        minsum_alpha=0.8, minsum_offset=0.0, qc_autodetect=False)
    k10 = DynamicParams(num_iter_max=120, num_iter_check_parity=10,
                        num_iter_first_check=0, loading_factor=2)

    sp_int8 = StaticParams(max_log_parallel_factor_user=8,
                           message_dtype="int8", algorithm="min-sum")
    sp_fp8 = StaticParams(max_log_parallel_factor_user=8,
                          message_dtype="float8_e5m2")
    p41_dyn = DynamicParams(num_iter_max=120, num_iter_check_parity=14,
                            num_iter_first_check=70, loading_factor=2)

    def general_code():
        return make_regular_code(2**20, 3, 6, seed=9), None, "built"

    def reg36_plain():  # no structure given: the decoder detects it
        return cs.get_reg36_code()[0], None, "cache"

    paths = [
        ("p41", cs.get_code, cs.SIGMA, sp, cs.N_FRAMES, p41_dyn),
        ("reg36", cs.get_reg36_code, cs.REG36_SIGMA, sp, cs.N_FRAMES, k10),
        ("general", general_code, cs.GENERAL_SIGMA, sp_general,
         cs.N_GENERAL_FRAMES, k10),
        ("general int8 min-sum", general_code, cs.GENERAL_SIGMA,
         sp_general_int8, cs.N_GENERAL_FRAMES, k10),
        ("reg36 int8 min-sum", reg36_plain, cs.MINSUM_SIGMA, sp_int8,
         cs.N_FRAMES, k10),
        ("reg36 fp8", cs.get_reg36_code, cs.REG36_SIGMA, sp_fp8, cs.N_FRAMES,
         k10),
        ("p41 fp8", cs.get_code, cs.SIGMA, sp_fp8, cs.N_FRAMES, p41_dyn),
    ]
    wanted = sys.argv[1:] or [p[0] for p in paths]
    unknown = set(wanted) - {p[0] for p in paths}
    if unknown:
        raise SystemExit(f"profile_chip: no path named {sorted(unknown)}")
    results = []
    for label, get, sigma, params, n, dyn in paths:
        if label not in wanted:
            continue
        code, s, _ = get()
        ch = BIAWGNChannel(sigma)
        batch = create_data(code, ch, 0, n, backend="native")
        dec = LDPCDecoder(code, ch, params, qc=s)
        results.append(profile_path(torch, label, dec, dyn, batch, n))
        del dec, batch
        torch.cuda.empty_cache()
    card = smi("name,power.limit,clocks.sm,power.draw")
    cs.log(f"after the runs (name, power limit, SM clock, power draw): "
           f"{card}")
    for r in results:
        r["card"] = card
        print(json.dumps(r), flush=True)


if __name__ == "__main__":
    main()
