"""Anneal protographs for minimum DECODE WORK at the sigma=0.94 point.

The PyTorch/CUDA port's twin of ``scripts/optimize_work.py``: its globals,
arguments and environment, and its output for the same seed. Numpy
on the host; it imports nothing of the JAX package (the port's
``codes/pexit.py`` is the copy it scores with) and runs from any
working directory.

Throughput = n / (avg_iters * itpv) and itpv is HBM-bound, i.e.
proportional to edges-per-variable. So the right code-design objective is
work = DE-iterations(sigma_op) * base_edge_count, not iterations alone
(optimize_fast.py) or threshold alone (optimize_proto.py): a base with 20
edges converging in 72 iterations beats one with 22 edges at 68.

Same constraint as optimize_fast.py: the 120-iteration P-EXIT threshold
must stay >= EDGE so the code still decodes sigma <= 0.95 like p41
(codes/protographs.py:P41_BASE scores work = 67 * 22 = 1474 here).

Usage: python scripts/optimize_work_torch.py [R] [n_punct] [steps] [seed]
Env: SIGMA_OP (default 0.945), EDGE (default 0.951), DE target sigma.
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

from optimize_fast_torch import iters_to_converge  # noqa: E402
from optimize_proto_torch import (  # noqa: E402
    neighbor,
    random_base,
    seed_bases,
)

from ldpc_decoder_tpu_torch.codes.pexit import pexit_threshold  # noqa: E402

SIGMA_OP = float(os.environ.get("SIGMA_OP", "0.945"))
EDGE = float(os.environ.get("EDGE", "0.951"))
MAX_DE = 200


def score(base, n_punct):
    """(-work, thr); None if infeasible. work = DE iters * edge count."""
    it = iters_to_converge(base, n_punct, SIGMA_OP)
    if it >= MAX_DE:
        return None
    punct = tuple(range(base.shape[1] - n_punct, base.shape[1]))
    thr = pexit_threshold(base, punct, lo=EDGE - 0.02, hi=1.0, tol=2e-3,
                          max_iters=120)
    if thr < EDGE:
        return None
    return (-float(it * base.sum()), thr)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    R = int(argv[0]) if len(argv) > 0 else 4
    n_punct = int(argv[1]) if len(argv) > 1 else 1
    steps = int(argv[2]) if len(argv) > 2 else 6000
    seed = int(argv[3]) if len(argv) > 3 else 0
    C = 2 * R - n_punct
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    print(f"work anneal {R}x{C}/{n_punct}p at sigma={SIGMA_OP} "
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
    print(f"  seed: work={-best_s[0]:.0f} thr={best_s[1]:.4f}", flush=True)
    for step in range(steps):
        nb = neighbor(cur, n_punct, rng)
        if nb is None:
            break
        s = score(nb, n_punct)
        if s is None:
            continue
        T = (0.7 * (1.0 - step / steps) + 0.05) * 30.0  # work-scale temp
        accept = s > cur_s or rng.random() < np.exp((s[0] - cur_s[0]) / T)
        if accept:
            cur, cur_s = nb, s
            if s > best_s:
                best, best_s = nb.copy(), s
                edges = int(best.sum())
                print(f"  step {step}: work={-s[0]:.0f} "
                      f"(iters={-s[0] / edges:.0f} x edges={edges}) "
                      f"thr={s[1]:.4f} *", flush=True)
                print("  base=" + repr(best.tolist()), flush=True)
        if step % 500 == 0:
            print(f"  ... step {step} cur_work={-cur_s[0]:.0f} "
                  f"[{time.perf_counter() - t0:.0f}s]", flush=True)
    edges = int(best.sum())
    print(f"BEST {R}x{C}/{n_punct}p: work={-best_s[0]:.0f} "
          f"(iters={-best_s[0] / edges:.0f} x edges={edges}) "
          f"thr={best_s[1]:.4f}")
    print("base=" + repr(best.tolist()))


if __name__ == "__main__":
    main()
