"""FER-scan a punctured protograph candidate on the PyTorch/CUDA port.

The port's counterpart of ``scripts/eval_proto.py``, with its registry, its
arguments and its EVAL_* variables: the candidate's P-EXIT threshold at 80
iterations (``codes/pexit.py``), then its two-stage girth-aware lift
(``codes/protographs.py``, seed 1), cached as
``codes_cache/proto_<NAME>_Z<Z>.alist``, then per sigma a pool generated on
the decoder's device (``create_pool_device(dec, ch, 0, n)``, n = min(frames,
2B) rounded to 32) decoded twice, the second reported: FER(>0), FER(>15),
BER, iterations and the decoding rate. The P-EXIT score is an estimate
(Gaussian-approximation error ~0.005-0.01 in sigma, and the finite-length
gap on top); this scan is the arbiter.

    [EVAL_ALG=sum-product] [EVAL_DTYPE=bfloat16] [EVAL_BETA=0.5]
    [EVAL_MAX_ITER=120] python scripts/eval_proto_torch.py NAME [Z]
    [n_frames] [sigma,sigma,...] [--device cpu]

It runs on the card; ``--device cpu`` runs the plain PyTorch versions on the
CPU with the lane count from a 1 GiB memory model (small Z: tests). Without
a card, ``--device cuda`` exits 1.
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

CACHE_DIR = os.path.join(REPO, "codes_cache")
CPU_MEMORY_BYTES = 1 << 30

# name -> (BASE, n_punct, prelift_m, coarse, fine_mod)
PROTOS = {
    # AR4JA reference family (asymptotic sigma* 0.9309 — expected to fail
    # at 0.94; the control datapoint)
    "ar4ja": (
        np.array([[1, 2, 0, 0, 0],
                  [0, 3, 1, 1, 1],
                  [0, 1, 2, 2, 1]], dtype=np.int8),
        1, 8, 512, 64,
    ),
}


def add_candidate(name, base, n_punct, m=8, coarse=512, fine_mod=64):
    PROTOS[name] = (np.asarray(base, dtype=np.int8), n_punct, m, coarse,
                    fine_mod)


# ---- annealed candidates (scripts/optimize_proto.py outputs) ----
# (bases keep their annealed column order; punctured cols are the LAST
# n_punct columns by construction)

# 4x7, 1 punctured: constrained P-EXIT sigma* (80it) 0.9461, (120it)
# 0.9549, asymptotic 0.9619 — the flagship p41
add_candidate("p41", [
    [0, 1, 1, 0, 1, 0, 3],
    [0, 1, 0, 1, 2, 1, 2],
    [0, 2, 0, 1, 1, 1, 1],
    [1, 0, 0, 0, 0, 0, 2],
], 1, m=8, coarse=512, fine_mod=64)

# p41 on the coarse-1024 lattice
add_candidate("p41c", [
    [0, 1, 1, 0, 1, 0, 3],
    [0, 1, 0, 1, 2, 1, 2],
    [0, 2, 0, 1, 1, 1, 1],
    [1, 0, 0, 0, 0, 0, 2],
], 1, m=8, coarse=1024, fine_mod=64)

# 5x8, 2 punctured: constrained (80it) 0.9426, (120it) 0.9555,
# asymptotic 0.9689 — more asymptotic margin, narrower tunnel than p41
add_candidate("p52b", [
    [1, 0, 0, 0, 0, 0, 1, 2],
    [0, 1, 0, 0, 0, 0, 0, 2],
    [0, 0, 0, 2, 0, 1, 1, 0],
    [0, 0, 2, 1, 2, 0, 1, 1],
    [0, 0, 0, 2, 1, 0, 1, 1],
], 2, m=8, coarse=512, fine_mod=64)

# 6x10, 2 punctured: constrained (80it) 0.9409, (120it) 0.9514
add_candidate("p62", [
    [0, 0, 0, 0, 1, 0, 2, 0, 1, 0],
    [0, 0, 1, 0, 1, 1, 0, 0, 0, 2],
    [0, 1, 0, 0, 0, 0, 2, 0, 0, 1],
    [0, 0, 0, 1, 0, 2, 0, 2, 2, 1],
    [0, 0, 1, 1, 0, 0, 0, 0, 0, 3],
    [1, 0, 1, 0, 0, 1, 2, 0, 0, 1],
], 2, m=4, coarse=512, fine_mod=64)


def settings() -> dict:
    """The EVAL_* variables, with the JAX script's defaults."""
    return {"alg": os.environ.get("EVAL_ALG", "sum-product"),
            "dtype": os.environ.get("EVAL_DTYPE", "bfloat16"),
            "beta": float(os.environ.get("EVAL_BETA", "0.5")),
            "max_iter": int(os.environ.get("EVAL_MAX_ITER", "120"))}


def threshold(name: str) -> float:
    """The candidate's P-EXIT threshold at 80 iterations."""
    from ldpc_decoder_tpu_torch.codes.pexit import pexit_threshold

    base, n_punct = PROTOS[name][:2]
    C = base.shape[1]
    return pexit_threshold(base, tuple(range(C - n_punct, C)), lo=0.7,
                           hi=1.0, tol=1e-3, max_iters=80)


def lift(name: str, Z: int, log=print):
    """(code, structure) of the candidate at ``Z``, from its cache file or
    lifted (two-stage, seed 1) and cached."""
    from ldpc_decoder_tpu_torch.codes.protographs import (
        make_protograph_code_two_stage,
    )
    from ldpc_decoder_tpu_torch.codes.qc import load_qc_alist, write_qc_alist

    base, n_punct, m, coarse, fine_mod = PROTOS[name]
    C = base.shape[1]
    cache = os.path.join(CACHE_DIR, f"proto_{name}_Z{Z}.alist")
    if os.path.exists(cache):
        code, s = load_qc_alist(cache)
        log(f"loaded {cache}")
        return code, s
    t0 = time.perf_counter()
    code, s = make_protograph_code_two_stage(
        base, tuple(range(C - n_punct, C)), m=m, Z=Z, seed=1, coarse=coarse,
        fine_mod=fine_mod)
    log(f"two-stage lift: {time.perf_counter() - t0:.1f}s")
    os.makedirs(CACHE_DIR, exist_ok=True)
    write_qc_alist(code, s, cache)
    return code, s


def scan_point(code, s, sigma: float, n_frames: int, device, cfg: dict,
               log=print) -> dict:
    """One sigma of the scan: the JAX script's decoder and protocol."""
    import torch

    from ldpc_decoder_tpu_torch.channels import BIAWGNChannel
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
    memory = CPU_MEMORY_BYTES if device.type == "cpu" else None
    ch = BIAWGNChannel(sigma)
    dec = LDPCDecoder(code, ch, StaticParams(
        max_log_parallel_factor_user=8, message_dtype=cfg["dtype"],
        algorithm=cfg["alg"], minsum_offset=cfg["beta"],
        device_memory_bytes=memory), qc=s, device=device)
    dyn = DynamicParams(num_iter_max=cfg["max_iter"],
                        num_iter_check_parity=10, loading_factor=2,
                        target_errors=15)
    B = dec.parallel_factor()
    n = min(n_frames, B * dyn.loading_factor)
    n = max(32, (n // 32) * 32)
    pool = create_pool_device(dec, ch, 0, n)
    for _ in range(2):
        results, stats = dec.decode_presorted(
            dyn, n, pool.values_sorted, pool.syn_sorted,
            fetch_results=False)
    errors = count_bit_errors(results, pool.ref_packed).cpu().numpy()
    pt = {"sigma": sigma, "fer1": float((errors > 0).mean()),
          "fer1_events": int((errors > 0).sum()),
          "fer15": float((errors > 15).mean()),
          "ber": float(errors.sum()) / (code.n_vars * n),
          "avg_iters": stats.avg_iter, "max_iters": stats.max_iter,
          "B": B, "n": n,
          "dec_mbps": code.n_vars / (stats.avg_iter
                                     * stats.iter_time_per_vector
                                     * 1048576.0),
          "tables": type(dec.tables).__name__}
    log(f"  sigma={sigma:.3f}: FER(>0)={pt['fer1']:.4f} "
        f"FER(>15)={pt['fer15']:.4f} BER={pt['ber']:.2e} iters avg/max="
        f"{pt['avg_iters']:.1f}/{pt['max_iters']} B={B} n={n} "
        f"{pt['dec_mbps']:.1f} Mb/s")
    return pt


def evaluate(name: str, Z: int = 2048, n_frames: int = 256,
             sigmas=(0.92, 0.93, 0.94), device="cuda", log=print) -> dict:
    """The script's run: threshold, lift, scan. Returns the record (the
    code and structure under "code" and "structure")."""
    import torch

    from ldpc_decoder_tpu_torch.probes._common import card

    base, n_punct, m = PROTOS[name][:3]
    R, C = base.shape
    cfg = settings()
    info = card(torch.device(device))  # the name and power limit
    thr = threshold(name)
    log(f"{name}: {R}x{C} m={m} Z={Z} -> n={C * m * Z} "
        f"({n_punct * m * Z} punctured), P-EXIT sigma*(80it)={thr:.4f}; "
        f"rates on {info['name']}, {info['power_limit']}")
    code, s = lift(name, Z, log)
    points = [scan_point(code, s, x, n_frames, device, cfg, log)
              for x in sigmas]
    return {"name": name, "threshold": thr, "code": code, "structure": s,
            "points": points, "card": info, **cfg}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("name", choices=sorted(PROTOS))
    p.add_argument("Z", nargs="?", type=int, default=2048)
    p.add_argument("n_frames", nargs="?", type=int, default=256)
    p.add_argument("sigmas", nargs="?", default="0.92,0.93,0.94")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device: --device cpu runs the plain versions",
              file=sys.stderr)
        return 1
    evaluate(args.name, args.Z, args.n_frames,
             [float(x) for x in args.sigmas.split(",")], args.device,
             log=lambda m: print(m, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
