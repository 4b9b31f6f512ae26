"""Command-line test harness of the PyTorch/CUDA port.

Flag-compatible with the reference binary (main.cpp:540-563) and with the
JAX package's CLI (``ldpc_decoder_tpu/cli.py``), whose flags, defaults,
messages, exit codes and Summary it keeps:

    python -m ldpc_decoder_tpu_torch.cli -f code.alist -c 1 -n 0.94 -p 8 \\
        -m 2 -e 15 -i 120

  -b f  BER above which a frame counts as errored (alternative to -e)
  -c n  channel: 0 bsc, 1 awgn, 2 erasure
  -e n  errors above which a frame counts as errored
  -f s  alist code file
  -i n  max BP iterations per frame (default 100)
  -l n  log level 1..3 (2: phase timings and per-superstep progress)
  -m n  loading factor (frames per run = m * parallel factor, default 4)
  -n f  channel noise level
  -p n  log2 of max frames decoded in parallel (default 5)
  -r n  number of runs (default 1)
  -s n  first frame index (seed base) for reproducibility

Long options as the JAX CLI's: --dtype, --check-period, --memory-bytes,
--lanes, --algorithm, --minsum-alpha, --minsum-offset, --minsum-clamp,
--qscale, --kernel (only "auto" runs here: the port has its own kernels)
and --first-check. ``--device`` picks the card (``cuda``, the default) or
the plain PyTorch passes on the CPU (``cpu``, which needs --memory-bytes or
--lanes for its lane count); without a card ``cuda`` exits 1 and never
falls back to the CPU.
"""

from __future__ import annotations

import argparse
import sys

import torch

from ldpc_decoder_tpu_torch.channels import make_channel
from ldpc_decoder_tpu_torch.codes.qc import load_qc_alist
from ldpc_decoder_tpu_torch.runtime.decoder import LDPCDecoder
from ldpc_decoder_tpu_torch.runtime.harness import do_test
from ldpc_decoder_tpu_torch.runtime.params import DynamicParams, StaticParams


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ldpc_decoder_tpu_torch",
        description="LDPC flood decoder test harness (PyTorch, CUDA "
        "kernels for Hopper)",
    )
    p.add_argument("-b", type=float, default=0.0, metavar="BER",
                   help="frame-error BER threshold (alternative to -e)")
    p.add_argument("-c", type=int, required=True, metavar="CHANNEL",
                   help="0 = bsc, 1 = awgn, 2 = erasure")
    p.add_argument("-e", type=int, default=0, metavar="ERRORS",
                   help="frame-error bit count threshold")
    p.add_argument("-f", type=str, required=True, metavar="ALIST",
                   help="code file (alist)")
    p.add_argument("-i", type=int, default=100, metavar="ITERS",
                   help="max decoding iterations per frame")
    p.add_argument("-l", type=int, default=1, choices=[1, 2, 3],
                   metavar="LOGLEVEL")
    p.add_argument("-m", type=int, default=4, metavar="LOADING",
                   help="loading factor")
    p.add_argument("-n", type=float, required=True, metavar="NOISE",
                   help="channel noise level")
    p.add_argument("-p", type=int, default=5, metavar="LOG2PAR",
                   help="log2 of max parallel frames")
    p.add_argument("-r", type=int, default=1, metavar="RUNS")
    p.add_argument("-s", type=int, default=0, metavar="START",
                   help="first frame index (reproducibility seed)")
    p.add_argument("--dtype", choices=["float32", "bfloat16", "int8"],
                   default="float32",
                   help="message storage dtype (int8: fixed-point "
                   "min-sum quantization, requires --algorithm min-sum; "
                   "see --qscale)")
    p.add_argument("--check-period", type=int, default=10,
                   help="iterations between parity checks/refills")
    p.add_argument("--memory-bytes", type=int, default=None,
                   help="override detected device memory")
    p.add_argument("--lanes", type=int, default=None, metavar="COUNT",
                   help="exact number of frames resident on device "
                   "(bypasses the memory model and the -p cap — the "
                   "caller owns the OOM risk)")
    p.add_argument("--algorithm", choices=["sum-product", "min-sum"],
                   default="sum-product",
                   help="check-node rule (min-sum: offset/normalized "
                   "two-minimum approximation, higher throughput, small "
                   "threshold loss; any code)")
    p.add_argument("--minsum-alpha", type=str, default="1.0",
                   metavar="ALPHA",
                   help="normalized-min-sum scaling: a float (uniform) "
                   "or a per-check-degree table 'd:a,d:a,...' with an "
                   "optional 0:a fallback for unlisted degrees, e.g. "
                   "'6:0.8125,7:0.8,0:0.8125'")
    p.add_argument("--minsum-offset", type=float, default=0.5,
                   metavar="BETA",
                   help="offset-min-sum subtraction beta "
                   "(|out| = max(alpha*min - beta, 0))")
    p.add_argument("--minsum-clamp", type=float, default=64.0,
                   metavar="CLAMP",
                   help="symmetric LLR clamp on min-sum variable "
                   "messages")
    p.add_argument("--qscale", type=float, default=4.0, metavar="SCALE",
                   help="int8 fixed-point steps per LLR unit (a power of "
                   "two in [2^-121, 2^125]; range +-127/SCALE, resolution "
                   "1/SCALE) for --dtype int8")
    p.add_argument("--kernel", choices=["auto", "pallas", "xla"],
                   default="auto",
                   help="decode kernel implementation (only 'auto', the "
                   "port's CUDA kernels, runs here)")
    p.add_argument("--first-check", type=int, default=0, metavar="ITER",
                   help="iteration of the first parity check (0 = every "
                   "--check-period). Skips provably-futile early checks "
                   "when no frame can converge before ITER; a too-large "
                   "value silently costs throughput (never correctness) — "
                   "the harness warns when the measured min iteration "
                   "count hits the burst boundary")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="decode on the CUDA card (the default) or with the "
                   "plain PyTorch passes on the CPU")
    return p


def parse_minsum_alpha(s: str):
    """--minsum-alpha value: a float, or a 'd:a,d:a' per-degree table
    (the degree-matched normalization for irregular codes,
    ops/qc_decode.resolve_minsum_alpha; 0 = fallback degree)."""
    s = s.strip()
    if ":" not in s:
        try:
            return float(s)
        except ValueError:
            raise ValueError(f"invalid --minsum-alpha {s!r}: expected a "
                             f"float or a 'd:a,d:a' table")
    table = {}
    for part in s.split(","):
        try:
            d, a = part.split(":")
            table[int(d)] = float(a)
        except ValueError:
            raise ValueError(
                f"invalid --minsum-alpha entry {part!r}: expected "
                f"'degree:alpha' (degree 0 = fallback)")
    return table


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.e and args.b:
        print("Cannot define both bit error rate and bit error count")
        return 1
    if args.m <= 0:
        print("Invalid overloading factor")
        return 1
    if args.r == 0:
        print("0 runs to perform, exiting")
        return 0
    if args.device == "cuda" and not torch.cuda.is_available():
        print("No CUDA device found: --device cuda needs an NVIDIA GPU "
              "(--device cpu runs the plain passes on the CPU)")
        return 1

    print(f"Code file name:{args.f}")
    try:
        channel = make_channel(args.c, args.n)
        # QC metadata headers (if present) give the structure; plain alists
        # are searched for it by the decoder
        code, qc = load_qc_alist(args.f)
    except (ValueError, OSError) as e:
        print(e)
        return 1

    target_errors = (
        args.e if args.e > 0 else int(code.n_vars * args.b)
    )
    print(f"Target number of errors per frame: {target_errors}\n")

    try:
        alpha = parse_minsum_alpha(args.minsum_alpha)
        static_p = StaticParams(
            max_log_parallel_factor_user=args.p,
            parallel_factor_user=args.lanes,
            message_dtype=args.dtype,
            device_memory_bytes=args.memory_bytes,
            algorithm=args.algorithm,
            kernel_impl=args.kernel,
            minsum_alpha=alpha,
            minsum_offset=args.minsum_offset,
            minsum_clamp=args.minsum_clamp,
            minsum_qscale=args.qscale,
        )
        decoder = LDPCDecoder(code, channel, static_p, qc=qc,
                              device=args.device)
    except (ValueError, NotImplementedError) as e:
        print(e)
        return 1
    dyn_p = DynamicParams(
        num_iter_max=args.i,
        num_iter_check_parity=args.check_period,
        loading_factor=args.m,
        target_errors=target_errors,
        num_iter_first_check=args.first_check,
    )
    report = do_test(
        code, channel, args.r, static_p, dyn_p,
        start_index=args.s, log_level=args.l, decoder=decoder,
    )
    print(report.report, end="")
    # same guard as bench.py: frames retiring AT the first check are
    # evidence the delayed-first-check burst may have eaten real retire
    # opportunities, deflating throughput (correctness is unaffected)
    if args.first_check and report.min_iter <= args.first_check:
        print(f"WARNING: min iteration count {report.min_iter} <= "
              f"--first-check {args.first_check}: frames retired at the "
              f"first allowed check, so some may have converged earlier "
              f"— the measured throughput is a lower bound; rerun with "
              f"--first-check 0 for an untainted number", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
