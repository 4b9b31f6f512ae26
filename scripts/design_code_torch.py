"""One-command LDPC code design on the PyTorch/CUDA port: anneal -> lift ->
seed search -> qualify.

The port's twin of ``scripts/design_code.py``, with its flags, its cache
names and ``#params`` headers, and its output for the same arguments,
environment and seed; it imports nothing of the JAX package, so it runs on
the card's host from any working directory.

    # reproduce the shipped flagship construction (skips the anneal —
    # P41_BASE is the recorded optimum for rate 1/2):
    python scripts/design_code_torch.py --rate 0.5 --n 1048576 \
        --out my_p41.alist

    # design a new code from scratch at another rate/target:
    python scripts/design_code_torch.py --rate 0.8 --threshold 0.62 \
        --shape 3x15 --punct 0 --steps 4000 --n 983040

    # full pipeline incl. the seed search + waterfall on the card:
    python scripts/design_code_torch.py --rate 0.5 --n 1048576 \
        --measure --seeds 1,2,3 --sigmas 0.94,0.95

Stages (each skippable / resumable via the cache):
  1. protomatrix anneal under Gaussian-DE with the objective work = DE
     iterations x edges per transmitted column
     (scripts/optimize_fast_torch.py machinery), unless the shape matches a
     recorded BEST_KNOWN optimum;
  2. two-stage girth-8 lift onto the seam lattice
     (codes/protographs.make_protograph_code_two_stage) per seed, on the
     host;
  3. (--measure) throughput at the operating point per seed
     (``measure_point``: bench.py's run_point protocol, pools made on the
     decoder's device), best seed wins;
  4. (--measure) waterfall qualification at --sigmas, --frames per point;
  5. alist written with the #params construction header.

``--measure`` decodes on the card (``--device cuda``, the default; without
a card it exits 1) with the hand-written kernels; ``--device cpu`` runs the
plain PyTorch versions with the lane count from a 1 GiB memory model (small
codes: tests). Without ``--measure`` no device is touched.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))
for _p in (REPO, HERE):
    if _p not in sys.path:
        sys.path.insert(0, _p)

CACHE = os.path.join(REPO, "codes_cache")
CPU_MEMORY_BYTES = 1 << 30


def pick_shape(rate, punct, shape):
    """(R, C, p) with rate = (C - R) / (C - p) over transmitted bits."""
    if shape:
        R, C = (int(x) for x in shape.lower().split("x"))
        return R, C, punct
    # prefer the 4..6-row families (measured sweet spot: larger shapes
    # slow the anneal without better thresholds, 3-row ones are weaker)
    for R in (4, 5, 6, 3, 7, 8):
        for C in range(R + 1, 3 * R + 1):
            if abs((C - R) / (C - punct) - rate) < 1e-9:
                return R, C, punct
    raise SystemExit(f"no small RxC shape matches rate={rate} with "
                     f"punct={punct}; pass --shape RxC")


def anneal_base(R, C, p, steps, sigma_op, edge, seed):
    """Work-objective Gaussian-DE anneal (optimize_fast machinery)."""
    os.environ.setdefault("SIGMA_OP", str(sigma_op))
    os.environ.setdefault("EDGE", str(edge))
    os.environ.setdefault("OBJ", "work")
    # optimize_fast_torch reads those at import: import it afresh, as the
    # JAX script's first import in its process does
    sys.modules.pop("optimize_fast_torch", None)
    import optimize_fast_torch as of
    from optimize_proto_torch import BEST_KNOWN, neighbor, seed_bases

    if steps == 0 and (R, C, p) in BEST_KNOWN:
        b = BEST_KNOWN[(R, C, p)]
        print(f"using recorded optimum for {R}x{C}/{p}p "
              f"(--steps 0): {b.tolist()}", flush=True)
        return np.asarray(b)
    rng = np.random.default_rng(seed)
    best, best_s = None, None
    for b in seed_bases(R, C, p, rng):
        s = of.score(b, p)
        if s and (best_s is None or s > best_s):
            best, best_s = b, s
    if best is None:
        raise SystemExit(
            f"no feasible protomatrix at sigma_op={of.SIGMA_OP} "
            f"edge={of.EDGE} for {R}x{C}/{p}p — lower --threshold")
    print(f"anneal seed: cost={-best_s[0]:.1f} thr={best_s[1]:.4f}",
          flush=True)
    t0 = time.perf_counter()
    cur, cur_s = best.copy(), best_s
    for step in range(steps):
        nb = neighbor(cur, p, rng)
        if nb is None:
            break
        s = of.score(nb, p)
        if s is None:
            continue
        T = 0.7 * (1.0 - step / max(steps, 1)) + 0.05
        if s > cur_s or rng.random() < np.exp((s[0] - cur_s[0]) / T):
            cur, cur_s = nb, s
            if s > best_s:
                best, best_s = nb.copy(), s
                print(f"  step {step}: cost={-s[0]:.1f} thr={s[1]:.4f} * "
                      f"({time.perf_counter()-t0:.0f}s)", flush=True)
    print(f"annealed base ({R}x{C}/{p}p): {best.tolist()}", flush=True)
    return best


def lift(base, p, n, seed, coarse, fine_mod, name):
    from ldpc_decoder_tpu_torch.codes.protographs import (
        make_protograph_code_two_stage,
    )
    from ldpc_decoder_tpu_torch.codes.qc import (
        load_qc_alist,
        read_alist_params,
        write_qc_alist,
    )

    base = np.asarray(base)
    R, C = base.shape
    # the JAX script's prelift factor; docs/DESIGNING_CODES.md section 2
    # lifts p41 at m = 8, and at n = 2^20 the m = 3 lift of the 4x7/1p
    # optimum converges to wrong codewords where m = 8 loses no frame
    # (PERF.md, section 6)
    m = max(2, int(base.max()))
    # total variables n_tot = C*m*Z >= requested n over TRANSMITTED bits:
    # n counts transmitted, punctured cols add p/C more
    n_tot = n * C // (C - p)
    Z = max(coarse, (n_tot // (C * m) // coarse) * coarse)
    params = {"base": json.dumps(base.tolist()), "punct": str(p),
              "m": str(m), "Z": str(Z), "seed": str(seed),
              "coarse": str(coarse), "fine_mod": str(fine_mod)}
    path = os.path.join(CACHE, name)
    if os.path.exists(path) and read_alist_params(path) == params:
        code, s = load_qc_alist(path)
        print(f"seed {seed}: cached {path}", flush=True)
        return code, s, path
    t0 = time.perf_counter()
    punct_cols = tuple(range(C - p, C))
    code, s = make_protograph_code_two_stage(
        base, punct_cols, m=m, Z=Z, seed=seed, coarse=coarse,
        fine_mod=fine_mod)
    os.makedirs(CACHE, exist_ok=True)
    write_qc_alist(code, s, path, params=params)
    print(f"seed {seed}: lifted n={code.n_vars} "
          f"(transmitted {code.n_vars - code.n_erased_vars}, Z={Z}, m={m}) "
          f"in {time.perf_counter()-t0:.0f}s -> {path}", flush=True)
    return code, s, path


def measure_point(code, qc, sigma, frames, device, check_period=14):
    """Decode ``frames`` frames of ``code`` at noise ``sigma`` on ``device``
    by bench.py's run_point protocol (bfloat16 sum-product, B <= 2^8 lanes
    or 2^BENCH_LOGP, loading factor max(2, ceil(frames / B)), at most 120
    iterations, a parity check every ``check_period`` from the
    start, a pool made on the device, one warm-up decode and the timed
    one). Returns its record: the statistics under run_point's keys, the
    decoding rate ``mbps`` = n / (avg_iter · itpv · 2^20), the tables'
    family, the card (name and power limit), and the timed decode's packed
    ``results`` (on the device), per-frame bit ``errors`` and
    ``iterations``."""
    import torch

    from ldpc_decoder_tpu_torch.channels import BIAWGNChannel
    from ldpc_decoder_tpu_torch.probes._common import card
    from ldpc_decoder_tpu_torch.runtime.datagen_device import (
        count_bit_errors,
        create_pool_device,
    )
    from ldpc_decoder_tpu_torch.runtime.decoder import LDPCDecoder
    from ldpc_decoder_tpu_torch.runtime.params import (
        DynamicParams,
        StaticParams,
    )

    device = torch.device(device)
    channel = BIAWGNChannel(sigma)
    logp = int(os.environ.get("BENCH_LOGP", "8"))
    dec = LDPCDecoder(code, channel, StaticParams(
        max_log_parallel_factor_user=logp, message_dtype="bfloat16",
        algorithm="sum-product",
        device_memory_bytes=(CPU_MEMORY_BYTES if device.type == "cpu"
                             else None)), qc=qc, device=device)
    B = dec.parallel_factor()
    lf = max(2, -(-frames // B))
    dyn = DynamicParams(num_iter_max=120,
                        num_iter_check_parity=check_period,
                        num_iter_first_check=0, loading_factor=lf,
                        target_errors=15)
    n = (min(frames, B * lf) // 32) * 32
    pool = create_pool_device(dec, channel, 0, n)
    for _ in range(2):  # the warm-up, then the timed decode
        results, stats = dec.decode_presorted(
            dyn, n, pool.values_sorted, pool.syn_sorted,
            fetch_results=False)
    errors = count_bit_errors(results, pool.ref_packed).cpu().numpy()
    frame_bits = code.n_vars
    itpv = stats.iter_time_per_vector
    return {"fer1": float((errors > 0).mean()),
            "fer15": float((errors > 15).mean()),
            "ber": float(errors.sum()) / (frame_bits * n),
            "avg_iters": round(stats.avg_iter, 2),
            "max_iters": stats.max_iter, "min_iters": stats.min_iter,
            "itpv": itpv, "elapsed": stats.elapsed_seconds, "B": B, "n": n,
            "mbps": frame_bits / (stats.avg_iter * itpv * 1048576.0),
            "tables": type(dec.tables).__name__, "card": card(device),
            "results": results, "errors": errors,
            "iterations": stats.iterations}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Design an LDPC code end to end (anneal/lift/"
                    "measure/qualify)")
    ap.add_argument("--rate", type=float, required=True,
                    help="rate over transmitted bits")
    ap.add_argument("--threshold", type=float, default=None,
                    help="target AWGN sigma (defaults to 97%% of the "
                         "Shannon sigma for --rate — the flagship p41 "
                         "reaches 97.2%%)")
    ap.add_argument("--n", type=int, default=1 << 20,
                    help="transmitted bits per frame (default 2^20)")
    ap.add_argument("--shape", default=None, help="RxC protomatrix shape")
    ap.add_argument("--punct", type=int, default=1,
                    help="punctured (state) columns (default 1)")
    ap.add_argument("--steps", type=int, default=0,
                    help="anneal steps (0 = use the recorded optimum for "
                         "the shape when one exists)")
    ap.add_argument("--seeds", default="3",
                    help="comma list of lift seeds to try")
    ap.add_argument("--coarse", type=int, default=1024)
    ap.add_argument("--fine-mod", type=int, default=64)
    ap.add_argument("--measure", action="store_true",
                    help="run the seed search + waterfall on --device")
    ap.add_argument("--sigmas", default=None,
                    help="waterfall sigma points (default: op, op+0.01)")
    ap.add_argument("--frames", type=int, default=512)
    ap.add_argument("--out", default=None, help="final alist name")
    ap.add_argument("--anneal-seed", type=int, default=0)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where --measure decodes (cpu: the plain "
                         "versions, small codes)")
    args = ap.parse_args(argv)
    if args.measure and args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("no CUDA device: --device cpu runs the plain versions",
                  file=sys.stderr)
            return 1

    from ldpc_decoder_tpu_torch.channels.biawgn import shannon_sigma

    sigma_star = shannon_sigma(args.rate)
    thr = args.threshold or round(0.97 * sigma_star, 3)
    sigma_op = round(thr - 0.01, 4)
    R, C, p = pick_shape(args.rate, args.punct, args.shape)
    print(f"rate {args.rate}: Shannon sigma*={sigma_star:.4f}, target "
          f"threshold {thr}, operating point {sigma_op}, shape {R}x{C}/{p}p",
          flush=True)

    os.environ["SIGMA_OP"] = str(sigma_op)
    os.environ["EDGE"] = str(thr)
    base = anneal_base(R, C, p, args.steps, sigma_op, thr, args.anneal_seed)

    seeds = [int(x) for x in args.seeds.split(",")]
    cands = []
    for sd in seeds:
        name = (args.out or
                f"designed_r{args.rate}_t{thr}_{R}x{C}p{p}.alist")
        if len(seeds) > 1:
            name = name.replace(".alist", f"_s{sd}.alist")
        code, s, path = lift(base, p, args.n, sd, args.coarse,
                             args.fine_mod, name)
        cands.append((sd, code, s, path))

    summary = {"rate": args.rate, "threshold_target": thr,
               "sigma_op": sigma_op, "shape": f"{R}x{C}/{p}p",
               "base": base.tolist(),
               "candidates": [p_ for _, _, _, p_ in cands]}
    if args.measure:
        best = None
        for sd, code, s, path in cands:
            st = measure_point(code, s, sigma_op, args.frames, args.device)
            mbps = st["mbps"]
            print(f"seed {sd}: {mbps:.1f} Mb/s avg_iters="
                  f"{st['avg_iters']} FER {st['fer1']:.4f}", flush=True)
            if best is None or mbps > best[0]:
                best = (mbps, sd, code, s, path)
        mbps, sd, code, s, path = best
        summary["best_seed"] = sd
        summary["mbps_at_op"] = round(mbps, 1)
        sigmas = ([float(x) for x in args.sigmas.split(",")]
                  if args.sigmas else [sigma_op, round(thr, 4)])
        points = []
        for sg in sigmas:
            st = measure_point(code, s, sg, args.frames, args.device)
            points.append({"sigma": sg, "fer1": st["fer1"],
                           "fer15": st["fer15"], "ber": st["ber"],
                           "avg_iters": st["avg_iters"],
                           "frames": st["n"]})
            print(f"waterfall sigma={sg}: FER(>0)={st['fer1']:.4f} "
                  f"BER={st['ber']:.3e}", flush=True)
        summary["waterfall"] = points
        summary["final_alist"] = path
        summary["card"] = st["card"]
    else:
        print("(construction only — pass --measure on a CUDA host for the "
              "seed search + waterfall qualification)", flush=True)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
