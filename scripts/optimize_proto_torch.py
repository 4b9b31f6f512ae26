"""Punctured-protograph search for the reference-matched operating point,
on the PyTorch/CUDA port: the twin of ``scripts/optimize_proto.py``, with
its globals, its arguments, its environment (DE_ITERS, ROW_DEG) and its
output for the same seed. It is numpy on the host and imports nothing of
the JAX package (``ldpc_decoder_tpu_torch/codes/pexit.py`` is its copy),
so it runs on the card's host from any working directory.

Round 1's RU (unpunctured, d_v<=8) ensembles plateau at an
iteration-constrained P-EXIT threshold of ~0.916 — fundamentally short of
the reference's sigma<=0.95 flagship code (README.md:109-115), which gets
its extra ~0.3 dB from PUNCTURED STATE VARIABLES (174,763 erased of 2^20,
ldpc_code.cpp:52-76). ARA/AR4JA-family protographs with a punctured
high-degree column reach sigma* ~0.95+ at max degree <= 8.

This script anneals small integer protomatrices (parallel edges allowed;
they are resolved later by the two-stage lift in codes/protographs.py)
under the ITERATION-CONSTRAINED P-EXIT score (convergence within DE_ITERS
Gaussian-DE iterations — the asymptotic threshold alone picks
narrow-tunnel bases that fail under the decoder's 120-iteration budget,
measured in round 1).

Usage: python scripts/optimize_proto_torch.py [R_b] [n_punct] [steps] [seed]
Shapes satisfy C_b = 2*R_b - n_punct (rate 1/2 over transmitted bits).
Prints the best base + its threshold-vs-iteration-budget profile.
"""

import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from ldpc_decoder_tpu_torch.codes.pexit import pexit_threshold  # noqa: E402
from ldpc_decoder_tpu_torch.codes.protographs import (  # noqa: E402
    AR4JA_RATE_12,
)

DE_ITERS = int(os.environ.get("DE_ITERS", "80"))  # decoder budget is 120
MAX_COL, MAX_ROW = 8, 8   # the JAX script's caps (its TPU tile rule)
MAX_ENTRY = 3             # parallel edges per cell (pre-lift resolves)

# best-known annealed bases per (R, C, n_punct) — seeds for refinement
BEST_KNOWN = {
    # constrained(80) 0.9461 / (120) 0.9549 / asym 0.9619  (round 2)
    (4, 7, 1): np.array(
        [[0, 1, 1, 0, 1, 0, 3], [0, 1, 0, 1, 2, 1, 2],
         [0, 2, 0, 1, 1, 1, 1], [1, 0, 0, 0, 0, 0, 2]], dtype=np.int64),
    # constrained(80) 0.9426 / (120) 0.9555 / asym 0.9689  (round 2)
    (5, 8, 2): np.array(
        [[1, 0, 0, 0, 0, 0, 1, 2], [0, 1, 0, 0, 0, 0, 0, 2],
         [0, 0, 0, 2, 0, 1, 1, 0], [0, 0, 2, 1, 2, 0, 1, 1],
         [0, 0, 0, 2, 1, 0, 1, 1]], dtype=np.int64),
    # constrained(80) 0.9409 / (120) 0.9514 / asym 0.9619  (round 2)
    (6, 10, 2): np.array(
        [[0, 0, 0, 0, 1, 0, 2, 0, 1, 0], [0, 0, 1, 0, 1, 1, 0, 0, 0, 2],
         [0, 1, 0, 0, 0, 0, 2, 0, 0, 1], [0, 0, 0, 1, 0, 2, 0, 2, 2, 1],
         [0, 0, 1, 1, 0, 0, 0, 0, 0, 3], [1, 0, 1, 0, 0, 1, 2, 0, 0, 1]],
        dtype=np.int64),
    # constrained(80) 0.9468 / (120) 0.9561; DE iters at 0.94: 66 vs
    # p41's 67 (round 3, scripts/out/proto_6x11_s5.log)
    (6, 11, 1): np.array(
        [[2, 3, 0, 0, 1, 0, 0, 0, 0, 0, 1], [1, 1, 0, 0, 0, 1, 1, 0, 0, 2, 1],
         [0, 2, 0, 0, 0, 0, 0, 1, 0, 2, 1], [0, 0, 0, 0, 0, 0, 0, 0, 1, 0, 2],
         [1, 0, 3, 0, 0, 1, 1, 1, 0, 1, 0], [0, 0, 0, 1, 0, 1, 0, 0, 0, 2, 3]],
        dtype=np.int64),
}


ROW_DEG = int(os.environ.get("ROW_DEG", "0"))  # 0 = free row degrees


def valid(base, n_punct):
    R, C = base.shape
    cd = base.sum(axis=0)
    rd = base.sum(axis=1)
    if (cd > MAX_COL).any() or (rd > MAX_ROW).any():
        return False
    if (rd < 2).any() or (cd < 1).any():
        return False
    if ROW_DEG and (rd != ROW_DEG).any():
        return False
    # punctured columns (the last n_punct) must be well protected
    if n_punct and (cd[-n_punct:] < 3).any():
        return False
    # stability-ish: at least one transmitted column of degree >= 3
    if (cd[: C - n_punct] >= 3).sum() == 0:
        return False
    return True


def score(base, n_punct, lo=0.70, hi=1.0):
    # lo must sit below any candidate's true threshold: scores clipped at
    # lo are indistinguishable and leave the annealer blind (the 8x13 run
    # stalled exactly this way at lo=0.85)
    punct = tuple(range(base.shape[1] - n_punct, base.shape[1]))
    return pexit_threshold(base, punct, lo=lo, hi=hi, tol=1e-3,
                           max_iters=DE_ITERS)


def random_base(R, C, n_punct, rng):
    # constructive sampler: per-column degree targets placed under row
    # capacity (plain i.i.d.-cell draws almost never satisfy the degree
    # caps at larger shapes)
    for _ in range(500):
        col_deg = rng.choice([1, 2, 2, 3, 3, 4], size=C)
        if n_punct:
            col_deg[-n_punct:] = rng.choice([3, 4, 5, 6], size=n_punct)
        if ROW_DEG:
            # resample until the totals admit row-regularity
            need = R * ROW_DEG - int(col_deg.sum())
            for _ in range(64):
                if need == 0:
                    break
                j = rng.integers(0, C)
                step = 1 if need > 0 else -1
                lo = 3 if (n_punct and j >= C - n_punct) else 1
                if lo <= col_deg[j] + step <= MAX_COL:
                    col_deg[j] += step
                    need -= step
            if need != 0:
                continue
        cap = np.full(R, MAX_ROW, dtype=np.int64)
        base = np.zeros((R, C), dtype=np.int64)
        ok = True
        for c in np.argsort(-col_deg):
            d = int(col_deg[c])
            for _ in range(d):
                avail = (cap > 0) & (base[:, c] < MAX_ENTRY)
                if not avail.any():
                    ok = False
                    break
                w = cap * avail
                r = rng.choice(R, p=w / w.sum())
                base[r, c] += 1
                cap[r] -= 1
            if not ok:
                break
        if ok and valid(base, n_punct):
            return base
    raise RuntimeError("no valid random base")


def seed_bases(R, C, n_punct, rng):
    out = []
    if (R, C, n_punct) in BEST_KNOWN:
        b = BEST_KNOWN[(R, C, n_punct)].copy()
        if valid(b, n_punct):  # e.g. ROW_DEG may exclude it
            out.append(b)
    if (R, C, n_punct) == (3, 5, 1):
        # AR4JA with its punctured column moved last
        b = AR4JA_RATE_12.astype(np.int64)
        out.append(b[:, [0, 2, 3, 4, 1]])
    # block-diagonal doubling of a known smaller base (coupled copies
    # explore larger shapes from a good start)
    for (r0, c0, p0), b0 in BEST_KNOWN.items():
        if (2 * r0, 2 * c0, 2 * p0) == (R, C, n_punct):
            big = np.zeros((R, C), np.int64)
            tr0, tc0 = c0 - p0, C - n_punct  # transmitted widths
            big[:r0, :tr0] = b0[:, :tr0]
            big[r0:, tr0:2 * tr0] = b0[:, :tr0]
            big[:r0, tc0:tc0 + p0] = b0[:, tr0:]
            big[r0:, tc0 + p0:] = b0[:, tr0:]
            if valid(big, n_punct):
                out.append(big)
    for _ in range(12):
        out.append(random_base(R, C, n_punct, rng))
    return out


def neighbor(base, n_punct, rng):
    for _ in range(200):
        nb = base.copy()
        r = rng.integers(0, base.shape[0])
        c = rng.integers(0, base.shape[1])
        if ROW_DEG:
            # row-degree-preserving: move one edge within a row
            c2 = rng.integers(0, base.shape[1])
            if c2 == c or nb[r, c] == 0 or nb[r, c2] >= MAX_ENTRY:
                continue
            nb[r, c] -= 1
            nb[r, c2] += 1
        elif rng.random() < 0.5 and nb[r, c] < MAX_ENTRY:
            nb[r, c] += 1
        elif nb[r, c] > 0:
            nb[r, c] -= 1
        else:
            continue
        if valid(nb, n_punct):
            return nb
    return None


def anneal(R, C, n_punct, steps, rng, t0=0.004):
    best, best_s = None, 0.0
    for b in seed_bases(R, C, n_punct, rng):
        s = score(b, n_punct)
        if s > best_s:
            best, best_s = b, s
    cur, cur_s = best.copy(), best_s
    print(f"  seeds best {best_s:.4f}", flush=True)
    for step in range(steps):
        T = t0 * (1.0 - step / steps) + 1e-4
        nb = neighbor(cur, n_punct, rng)
        if nb is None:
            break
        s = score(nb, n_punct, lo=max(0.70, cur_s - 0.03))
        if s > cur_s or rng.random() < np.exp((s - cur_s) / T):
            cur, cur_s = nb, s
            if s > best_s:
                best, best_s = nb.copy(), s
                # print the base on every improvement: long anneals may
                # be killed and the best-so-far must not be lost
                print(f"  step {step}: {s:.4f} * "
                      f"BASE={nb.tolist()}", flush=True)
    return best, best_s


def profile(base, n_punct):
    punct = tuple(range(base.shape[1] - n_punct, base.shape[1]))
    out = {}
    for it in (40, 60, 80, 120, 1000):
        out[it] = pexit_threshold(base, punct, lo=0.85, hi=1.0, tol=1e-3,
                                  max_iters=it)
    return out


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    R = int(argv[0]) if len(argv) > 0 else 4
    n_punct = int(argv[1]) if len(argv) > 1 else 1
    steps = int(argv[2]) if len(argv) > 2 else 4000
    seed = int(argv[3]) if len(argv) > 3 else 0
    C = 2 * R - n_punct
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    print(f"annealing {R}x{C} with {n_punct} punctured "
          f"(DE_ITERS={DE_ITERS}, steps={steps}, seed={seed})", flush=True)
    best, best_s = anneal(R, C, n_punct, steps, rng)
    dt = time.perf_counter() - t0
    print(f"FINAL constrained threshold {best_s:.4f} ({dt:.0f}s)")
    print("threshold vs DE-iteration budget:", profile(best, n_punct))
    print("col degrees:", best.sum(axis=0).tolist())
    print("row degrees:", best.sum(axis=1).tolist())
    print("PUNCT =", n_punct, "(last cols)")
    print("BASE = np.array(", best.tolist(), ", dtype=np.int8)")


if __name__ == "__main__":
    main()
