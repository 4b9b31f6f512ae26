"""Anneal protographs for throughput AT THEIR OWN FER~0.05 edge point.

The PyTorch/CUDA port's twin of ``scripts/optimize_edge.py``: its globals,
arguments and environment, and its output for the same seed. Numpy
on the host; it imports nothing of the JAX package (the port's
``codes/pexit.py`` is the copy it scores with) and runs from any
working directory.

Every previous anneal optimized convergence in the safe
region (sigma=0.94/0.945) or the threshold itself; no base was ever
designed to be FAST at the sigma where its own FER(>=1) ~ 0.047 — which
is exactly how the reference's code is operated (README.md:99,106).

Self-referential objective: for each candidate,
    sigma_op(base) = thr120(base) - DELTA        (its own edge)
    cost = DE_iters(sigma_op) * edges_per_transmitted_column
minimized subject to sigma_op >= SIGMA_MIN (a channel at least as hard
as the one where we must dominate the reference).

Why this has room: all BEST_KNOWN bases have cost 370-440 because
max-threshold anneals produce capacity-MATCHED tunnels, which are soft
near closure — iters(thr120 - delta) ~ 120/(1 + 120*delta/A) with the
softness A ~ 1.7 measured across all of them. A base that trades
asymptotic threshold for an ABRUPT pinch (small A) converges much
faster a fixed delta below its 120-iteration threshold. DELTA = 0.002
is the p41-calibrated finite-length backoff (thr120 0.9549, measured
FER 0.049 at 0.953; fer_stats_edge artifacts).

Usage: python scripts/optimize_edge_torch.py [R] [n_punct] [steps] [seed]
Env: DELTA (0.002), SIGMA_MIN (0.9455), OBJ (work|iters)
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

from ldpc_decoder_tpu_torch.codes.pexit import pexit_threshold  # noqa: E402
from optimize_fast_torch import iters_to_converge  # noqa: E402
from optimize_proto_torch import (  # noqa: E402
    BEST_KNOWN,
    neighbor,
    random_base,
    seed_bases,
    valid,
)

DELTA = float(os.environ.get("DELTA", "0.002"))
SIGMA_MIN = float(os.environ.get("SIGMA_MIN", "0.9455"))
OBJ = os.environ.get("OBJ", "work")
MAX_DE = 200


def score(base, n_punct):
    """(-cost, thr120) at the base's own edge; None if infeasible."""
    R, C = base.shape
    punct = tuple(range(C - n_punct, C))
    thr = pexit_threshold(base, punct, lo=SIGMA_MIN - 0.004, hi=0.985,
                          tol=5e-4, max_iters=120)
    sig_op = thr - DELTA
    if sig_op < SIGMA_MIN:
        return None
    it = iters_to_converge(base, n_punct, sig_op)
    if it >= MAX_DE:
        return None
    cost = it
    if OBJ == "work":
        cost = it * float(base.sum()) / (C - n_punct)
    return (-cost, thr)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    R = int(argv[0]) if len(argv) > 0 else 4
    n_punct = int(argv[1]) if len(argv) > 1 else 1
    steps = int(argv[2]) if len(argv) > 2 else 4000
    seed = int(argv[3]) if len(argv) > 3 else 0
    C = 2 * R - n_punct
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    print(f"edge anneal {R}x{C}/{n_punct}p: min {OBJ} at thr120-{DELTA} "
          f"subject to sigma_op>={SIGMA_MIN}; steps={steps} seed={seed}",
          flush=True)

    best, best_s = None, None
    for b in seed_bases(R, C, n_punct, rng):
        s = score(b, n_punct)
        if s and (best_s is None or s > best_s):
            best, best_s = b, s
    if best is None:
        print("no feasible seed; relax SIGMA_MIN")
        return
    cur, cur_s = best.copy(), best_s
    print(f"  seed: cost={-best_s[0]:.1f} thr={best_s[1]:.4f}", flush=True)
    for step in range(steps):
        nb = neighbor(cur, n_punct, rng)
        if nb is None:
            break
        s = score(nb, n_punct)
        if s is None:
            continue
        T = 0.7 * (1.0 - step / steps) + 0.05
        accept = s > cur_s or rng.random() < np.exp((s[0] - cur_s[0]) / T)
        if accept:
            cur, cur_s = nb, s
            if s > best_s:
                best, best_s = nb.copy(), s
                sig_op = s[1] - DELTA
                print(f"  step {step}: cost={-s[0]:.1f} thr={s[1]:.4f} "
                      f"sig_op={sig_op:.4f} "
                      f"iters={iters_to_converge(nb, n_punct, sig_op)} *",
                      flush=True)
    thr = best_s[1]
    sig_op = thr - DELTA
    it = iters_to_converge(best, n_punct, sig_op)
    print(f"FINAL cost={-best_s[0]:.1f}: iters={it} at sigma_op={sig_op:.4f}"
          f" (thr120={thr:.4f}, epc={best.sum()/(C-n_punct):.2f}) "
          f"({time.perf_counter()-t0:.0f}s)")
    print("col degrees:", best.sum(axis=0).tolist())
    print("row degrees:", best.sum(axis=1).tolist())
    print("BASE = np.array(", best.tolist(), ", dtype=np.int8)")
    p41 = BEST_KNOWN.get((4, 7, 1))
    if p41 is not None:
        pthr = pexit_threshold(p41, (6,), lo=0.93, hi=0.985, tol=5e-4,
                               max_iters=120)
        pit = iters_to_converge(p41, 1, pthr - DELTA)
        print(f"baseline p41: cost={pit * p41.sum() / 6:.1f} "
              f"(iters={pit} at {pthr - DELTA:.4f})")


if __name__ == "__main__":
    main()
