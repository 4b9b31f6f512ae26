"""Anneal protographs FOR (normalized/offset) min-sum decoding.

The PyTorch/CUDA port's twin of ``scripts/optimize_minsum.py``: its globals,
arguments and environment, and its output for the same seed. Numpy
on the host; it imports nothing of the JAX package (the port's
``codes/pexit.py`` is the copy it scores with) and runs from any
working directory.

Every previous anneal optimized under exact-BP density evolution; min-sum
was only ever tried post-hoc on BP-designed codes. Round-4 measurements
(scripts/out/nms_*.log, oms_probe.log) with the sampled min-sum DE
(codes/pexit.minsum_de_run, validated against on-chip truth):

- normalized min-sum CANNOT reach sigma 0.94 on any known base (best
  threshold 0.9125 at alpha=0.8 on p41; BP-designed bases lose >= 0.04
  sigma under NMS);
- OFFSET min-sum (beta ~ 0.4-0.5, alpha ~ 0.95-1.0) does converge at
  0.94 on p41 — but marginally: 115-253 DE iterations depending on MC
  seed (the ensemble sits near its OMS threshold).

So this anneal searches bases whose OMS convergence at SIGMA_OP is FAST
(decisively inside the threshold), minimizing work = iterations x edges
per transmitted column. Because near-threshold iteration counts are
MC-noisy, candidates are scored as the mean over two DE seeds and the
edge-margin check runs only on would-be-accepted candidates.

Usage: python scripts/optimize_minsum_torch.py [R] [n_punct] [steps] [seed]
Env: ALPHA (default 0.95; or "d:a,...,0:a" per-degree), BETA (0.4),
     SIGMA_OP (0.94), EDGE_SIGMA (0.9425), N_SAMPLES (6000), MAX_DE (150),
     SEED_BASE (JSON base matrix to seed the search — laddering)
"""

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

from ldpc_decoder_tpu_torch.codes.pexit import minsum_de_run  # noqa: E402
from optimize_proto_torch import (  # noqa: E402
    neighbor,
    seed_bases,
)

SIGMA_OP = float(os.environ.get("SIGMA_OP", "0.94"))
EDGE_SIGMA = float(os.environ.get("EDGE_SIGMA", "0.9425"))
N_SAMPLES = int(os.environ.get("N_SAMPLES", "6000"))
MAX_DE = int(os.environ.get("MAX_DE", "150"))
BETA = float(os.environ.get("BETA", "0.4"))
DE_SEEDS = (7, 11)


def parse_alpha(s):
    if ":" not in s:
        return float(s)
    return tuple(
        (int(kv.split(":")[0]), float(kv.split(":")[1]))
        for kv in s.split(",")
    )


ALPHA = parse_alpha(os.environ.get("ALPHA", "0.95"))


def de_iters(base, n_punct, sigma, seed, max_iters):
    punct = tuple(range(base.shape[1] - n_punct, base.shape[1]))
    # rank by the 10-sample error crossing, not the 0/N extreme-tail
    # event (the latter has huge seed-to-seed variance near threshold)
    ok, it = minsum_de_run(base, sigma, punct, alpha=ALPHA, beta=BETA,
                           n_samples=N_SAMPLES, max_iters=max_iters,
                           seed=seed, stall_iters=100,
                           target_err=10.0 / N_SAMPLES)
    return it if ok else None


def score(base, n_punct):
    """Negative mean work at SIGMA_OP over DE_SEEDS, or None."""
    its = []
    for sd in DE_SEEDS:
        it = de_iters(base, n_punct, SIGMA_OP, sd, MAX_DE)
        if it is None:
            return None
        its.append(it)
    work = float(np.mean(its)) * float(base.sum()) / (
        base.shape[1] - n_punct)
    return (-work, -max(its))


def edge_ok(base, n_punct):
    return de_iters(base, n_punct, EDGE_SIGMA, 13,
                    int(MAX_DE * 2.5)) is not None


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    R = int(argv[0]) if len(argv) > 0 else 4
    n_punct = int(argv[1]) if len(argv) > 1 else 1
    steps = int(argv[2]) if len(argv) > 2 else 1200
    seed = int(argv[3]) if len(argv) > 3 else 0
    C = 2 * R - n_punct
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    print(f"min-sum anneal {R}x{C}/{n_punct}p at sigma={SIGMA_OP} "
          f"edge={EDGE_SIGMA} alpha={ALPHA} beta={BETA} "
          f"N={N_SAMPLES} maxDE={MAX_DE} steps={steps} seed={seed}",
          flush=True)

    cands = []
    if os.environ.get("SEED_BASE"):
        cands.append(np.asarray(json.loads(os.environ["SEED_BASE"]),
                                dtype=np.int64))
    cands.extend(seed_bases(R, C, n_punct, rng))
    best, best_s = None, None
    for b in cands:
        if b.shape != (R, C):
            continue
        s = score(b, n_punct)
        if s and (best_s is None or s > best_s):
            best, best_s = b, s
            print(f"  seed ok: work={-s[0]:.1f} worst-iters={-s[1]}",
                  flush=True)
    if best is None:
        print(f"no feasible seed: nothing converges at {SIGMA_OP} within "
              f"{MAX_DE} iters under (alpha={ALPHA}, beta={BETA}) — "
              f"ladder up from a lower SIGMA_OP via SEED_BASE")
        return
    cur, cur_s = best.copy(), best_s
    for step in range(steps):
        nb = neighbor(cur, n_punct, rng)
        if nb is None:
            break
        s = score(nb, n_punct)
        if s is None:
            continue
        T = 3.0 * (1.0 - step / steps) + 0.2
        accept = s > cur_s or rng.random() < np.exp((s[0] - cur_s[0]) / T)
        if accept:
            if s > best_s and not edge_ok(nb, n_punct):
                continue  # fast at op but no margin above it — skip
            cur, cur_s = nb, s
            if s > best_s:
                best, best_s = nb.copy(), s
                print(f"  step {step}: work={-s[0]:.1f} "
                      f"worst-iters={-s[1]} * "
                      f"({time.perf_counter()-t0:.0f}s)", flush=True)
    # high-accuracy re-check of the winner
    punct = tuple(range(C - n_punct, C))
    checks = [
        minsum_de_run(best, SIGMA_OP, punct, alpha=ALPHA, beta=BETA,
                      n_samples=30000, max_iters=MAX_DE * 2, seed=sd,
                      stall_iters=120)
        for sd in (1, 2, 3)
    ]
    ok_e, it_e = minsum_de_run(best, EDGE_SIGMA, punct, alpha=ALPHA,
                               beta=BETA, n_samples=30000,
                               max_iters=MAX_DE * 3, seed=1,
                               stall_iters=120)
    print(f"FINAL work={-best_s[0]:.1f} recheck(30k, seeds 1-3): "
          f"op {checks} edge {ok_e}/{it_e} "
          f"({time.perf_counter()-t0:.0f}s)")
    print("col degrees:", best.sum(axis=0).tolist())
    print("row degrees:", best.sum(axis=1).tolist())
    print("BASE = np.array(", best.tolist(), ", dtype=np.int8)")


if __name__ == "__main__":
    main()
