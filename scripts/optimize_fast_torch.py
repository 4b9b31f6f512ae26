"""Anneal protographs for FAST convergence at the sigma=0.94 operating
point (fewest DE iterations), subject to a waterfall-edge constraint.

The PyTorch/CUDA port's twin of ``scripts/optimize_fast.py``: its globals,
arguments and environment, and its output for the same seed. Numpy
on the host; it imports nothing of the JAX package (the port's
``codes/pexit.py`` is the copy it scores with) and runs from any
working directory.

The p41 flagship decodes sigma 0.94 at FER 0 but needs avg 71 BP
iterations; throughput = n/(avg_iters * itpv), so iterations are as
valuable as kernel time. Objective here: minimize Gaussian-DE
iterations-to-converge at SIGMA_OP (+ small threshold tie-break),
requiring the 120-iteration threshold stays >= EDGE (so the code still
decodes sigma<=0.95 like p41).

Usage: python scripts/optimize_fast_torch.py [R] [n_punct] [steps] [seed]
"""

import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))
for _p in (REPO, HERE):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from ldpc_decoder_tpu_torch.codes.pexit import (  # noqa: E402
    J,
    J_inv,
    pexit_threshold,
)
from optimize_proto_torch import (  # noqa: E402
    BEST_KNOWN,
    neighbor,
    random_base,
    seed_bases,
    valid,
)

SIGMA_OP = float(os.environ.get("SIGMA_OP", "0.945"))
EDGE = float(os.environ.get("EDGE", "0.951"))
MAX_DE = 200


def iters_to_converge(base, n_punct, sigma, target=1.0 - 1e-6):
    """DE iterations until all APP MIs reach target (MAX_DE if never)."""
    base = np.asarray(base)
    R, C = base.shape
    rows, cols = np.nonzero(base)
    mult = base[rows, cols]
    er = np.repeat(rows, mult)
    ec = np.repeat(cols, mult)
    punct = np.zeros(C, dtype=bool)
    punct[C - n_punct:] = True
    sig_ch2 = np.where(punct[ec], 0.0, (2.0 / sigma) ** 2)
    ch2_col = np.where(punct, 0.0, (2.0 / sigma) ** 2)
    I_ec = np.zeros(er.shape[0])
    for it in range(1, MAX_DE + 1):
        s2 = J_inv(I_ec) ** 2
        tot_v = np.bincount(ec, weights=s2, minlength=C)
        I_ev = J(np.sqrt(np.maximum(tot_v[ec] - s2, 0.0) + sig_ch2))
        t2 = J_inv(1.0 - I_ev) ** 2
        tot_c = np.bincount(er, weights=t2, minlength=R)
        I_new = 1.0 - J(np.sqrt(np.maximum(tot_c[er] - t2, 0.0)))
        if np.allclose(I_new, I_ec, atol=1e-10):
            return MAX_DE
        I_ec = I_new
        if J(np.sqrt(tot_v + ch2_col)).min() >= target:
            return it
    return MAX_DE


OBJ = os.environ.get("OBJ", "iters")  # iters | work


def score(base, n_punct):
    """(negative decode cost at SIGMA_OP, threshold) — higher is better;
    bases whose 120-iteration threshold misses EDGE are rejected outright.

    OBJ=iters: cost = DE iterations alone. OBJ=work: cost = iterations x
    edges-per-column — the actual decode work per transmitted bit (both
    HBM traffic and φ evals scale with the edge count; measured round 3:
    a 62-iteration base with 3.55 edges/col decodes SLOWER than p41's
    67 x 3.14, scripts/out/fast611_run.log)."""
    it = iters_to_converge(base, n_punct, SIGMA_OP)
    if it >= MAX_DE:
        return None
    punct = tuple(range(base.shape[1] - n_punct, base.shape[1]))
    thr = pexit_threshold(base, punct, lo=EDGE - 0.02, hi=1.0, tol=2e-3,
                          max_iters=120)
    if thr < EDGE:
        return None
    cost = it
    if OBJ == "work":
        cost = it * float(base.sum()) / base.shape[1]
    return (-cost, thr)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    R = int(argv[0]) if len(argv) > 0 else 4
    n_punct = int(argv[1]) if len(argv) > 1 else 1
    steps = int(argv[2]) if len(argv) > 2 else 6000
    seed = int(argv[3]) if len(argv) > 3 else 0
    C = 2 * R - n_punct
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    print(f"fast-convergence anneal {R}x{C}/{n_punct}p at sigma={SIGMA_OP} "
          f"edge>={EDGE} steps={steps} seed={seed}", flush=True)

    best, best_s = None, None
    for b in seed_bases(R, C, n_punct, rng):
        s = score(b, n_punct)
        if s and (best_s is None or s > best_s):
            best, best_s = b, s
    if best is None:
        print("no feasible seed; relax EDGE")
        return
    cur, cur_s = best.copy(), best_s
    print(f"  seed: iters={-best_s[0]} thr={best_s[1]:.4f}", flush=True)
    stall = 0
    for step in range(steps):
        nb = neighbor(cur, n_punct, rng)
        if nb is None:
            break
        s = score(nb, n_punct)
        if s is None:
            continue
        T = 0.7 * (1.0 - step / steps) + 0.05
        accept = s > cur_s or rng.random() < np.exp(
            (s[0] - cur_s[0]) / T)
        if accept:
            cur, cur_s = nb, s
            if s > best_s:
                best, best_s = nb.copy(), s
                stall = 0
                print(f"  step {step}: iters={-s[0]} thr={s[1]:.4f} *",
                      flush=True)
        stall += 1
    print(f"FINAL iters={-best_s[0]} at sigma {SIGMA_OP}, "
          f"thr(120)={best_s[1]:.4f} ({time.perf_counter()-t0:.0f}s)")
    print("col degrees:", best.sum(axis=0).tolist())
    print("row degrees:", best.sum(axis=1).tolist())
    print("BASE = np.array(", best.tolist(), ", dtype=np.int8)")
    print("baseline p41 iters:",
          iters_to_converge(
              BEST_KNOWN[(4, 7, 1)], 1, SIGMA_OP) if (4, 7, 1) in BEST_KNOWN
          else "n/a")


if __name__ == "__main__":
    main()
