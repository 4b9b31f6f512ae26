"""Measure the general (non-QC) gather path at n = 2^20 on the PyTorch/CUDA
port.

The port's counterpart of ``scripts/bench_general.py``, with its protocol: a
random (3,6) code without QC structure (``make_regular_code(2**20, 3, 6,
seed=9)``), exactly B lanes (default 384) of bfloat16 sum-product messages
at sigma 0.84, k = 10, at most 120 iterations, loading factor 1,
``qc_autodetect=False`` (the general kernels, never a detected QC family);
B frames from the host datagen, converted to LLRs on the host and uploaded
in the decoder's sorted layouts before the clock (``upload_pools``); the
first decode warms up, the second is the one timed. It prints the JAX
script's lines; on the card each rate goes beside the card's name and power
limit.

    python scripts/bench_general_torch.py [B] [sigma] [--device cpu]
        [--n-vars N]

It runs on the card; ``--device cpu`` runs the plain PyTorch versions on the
CPU (with ``--n-vars`` a small code: tests). Without a card, ``--device
cuda`` exits 1.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

N_VARS = 1 << 20
MAX_ITER = 120
CHECK_PERIOD = 10


def check_lanes(B: int) -> None:
    """Refuse a stale log2 lane cap: before the JAX script's round-4
    protocol the positional argument was log2 of the lanes (8 for 256); it
    is now the exact lane count, so a value under 128 is refused."""
    if 0 < B < 128:
        raise SystemExit(
            f"B={B} looks like a stale log2 lane cap (the positional arg is "
            f"an EXACT lane count); pass the real count, e.g. {1 << B}")


def run(B_force: int = 384, sigma: float = 0.84, n_vars: int = N_VARS,
        device="cuda", log=print) -> dict:
    """The protocol at ``B_force`` lanes; returns the timed decode's
    record: its packed words [n, n_words] and per-frame iterations beside
    the printed numbers."""
    import torch

    from ldpc_decoder_tpu_torch.channels import BIAWGNChannel
    from ldpc_decoder_tpu_torch.codes.generate import make_regular_code
    from ldpc_decoder_tpu_torch.probes._common import card
    from ldpc_decoder_tpu_torch.runtime.datagen import create_data
    from ldpc_decoder_tpu_torch.runtime.decoder import LDPCDecoder
    from ldpc_decoder_tpu_torch.runtime.params import (
        DynamicParams,
        StaticParams,
    )

    check_lanes(B_force)
    device = torch.device(device)
    info = card(device)  # the name and power limit beside the rate
    t0 = time.perf_counter()
    code = make_regular_code(n_vars, 3, 6, seed=9)
    log(f"generated (3,6) n={n_vars} random (non-QC) code in "
        f"{time.perf_counter() - t0:.1f}s")

    ch = BIAWGNChannel(sigma)
    dec = LDPCDecoder(code, ch, StaticParams(
        parallel_factor_user=B_force, message_dtype="bfloat16",
        qc_autodetect=False), device=device)
    B = dec.parallel_factor()
    dyn = DynamicParams(num_iter_max=MAX_ITER,
                        num_iter_check_parity=CHECK_PERIOD,
                        loading_factor=1, target_errors=15)
    n = max(32, (B // 32) * 32)
    log(f"B={B} frames={n} sigma={sigma}")
    t0 = time.perf_counter()
    batch = create_data(code, ch, 0, n)
    log(f"datagen: {time.perf_counter() - t0:.1f}s")

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    # the pools in the decoder's sorted layouts before the clock (the LLRs
    # computed on the host, as the JAX script does)
    t0 = time.perf_counter()
    pool_values, pool_syn = dec.upload_pools(
        ch.llr_np(batch.values).astype(np.float32), batch.syndromes)
    sync()
    log(f"upload: {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    dec.decode_presorted(dyn, n, pool_values, pool_syn, input_is_llr=True)
    sync()
    log(f"decode 1 (incl. compile): {time.perf_counter() - t0:.1f}s")
    results, stats = dec.decode_presorted(dyn, n, pool_values, pool_syn,
                                          input_is_llr=True)

    errors = np.bitwise_count(batch.ref_bits_packed() ^ results).sum(axis=1)
    itpv = stats.iter_time_per_vector
    mbps = n_vars / (stats.avg_iter * itpv * 1048576.0)
    ber = float(errors.sum()) / (n_vars * n)
    fer1 = float((errors > 0).mean())
    log(f"iters avg/max/min {stats.avg_iter:.1f}/{stats.max_iter}/"
        f"{stats.min_iter}, itpv={itpv:.3e}s, BER={ber:.2e} "
        f"FER(>0)={fer1:.4f}")
    log(f"general-path decoding throughput: {mbps:.1f} Mb/s (reference "
        f"CSR-walk baseline: 200.3 Mb/s on an RTX 3080); {info['name']}, "
        f"{info['power_limit']}")
    return {"B": B, "n": n, "sigma": sigma, "avg_iter": stats.avg_iter,
            "max_iter": stats.max_iter, "min_iter": stats.min_iter,
            "itpv": itpv, "ber": ber, "fer1": fer1, "dec_mbps": mbps,
            "card": info, "results": results,
            "iterations": np.asarray(stats.iterations)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("B", nargs="?", type=int, default=384,
                   help="exact lane count (default 384)")
    p.add_argument("sigma", nargs="?", type=float, default=0.84)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--n-vars", type=int, default=N_VARS)
    args = p.parse_args(argv)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device: --device cpu runs the plain versions",
              file=sys.stderr)
        return 1
    check_lanes(args.B)
    run(args.B, args.sigma, args.n_vars, args.device,
        log=lambda m: print(m, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
