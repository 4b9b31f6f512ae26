"""Protograph EXIT (P-EXIT) analysis for BI-AWGN thresholds.

JAX-free copy of ``ldpc_decoder_tpu/codes/pexit.py`` with its names and
defaults (:func:`J`, :func:`J_inv`, :func:`pexit_converges`,
:func:`pexit_threshold`, :func:`minsum_de_run`,
:func:`minsum_de_threshold`); ``tests/test_torch_pexit.py`` holds it equal.

Gaussian-approximation density evolution on a protograph (Liva/Chiani
P-EXIT): tracks per-edge mutual information through VN/CN updates using the
ten Brink J-function. Used to score candidate base matrices before they are
lifted (``codes/protographs.py``) and qualified on the card
(``scripts/eval_proto_torch.py``). The Gaussian approximation is good to
~0.01 in sigma for these ensembles; a FER measurement remains the final
arbiter.
"""

from __future__ import annotations

import numpy as np

# ten Brink J-function approximation (Brannstrom/Rasmussen/Grant)
_A1, _B1, _C1 = -0.0421061, 0.209252, -0.00640081
_A2, _B2, _C2 = 0.00181491, -0.142675, -0.0822054
_D2 = 0.0549608


def J(sigma):
    """Mutual information of a consistent Gaussian LLR with std sigma."""
    s = np.asarray(sigma, dtype=np.float64)
    out = np.where(
        s < 1.6363,
        _A1 * s**3 + _B1 * s**2 + _C1 * s,
        1.0 - np.exp(_A2 * s**3 + _B2 * s**2 + _C2 * s + _D2),
    )
    return np.clip(out, 0.0, 1.0 - 1e-12)


def J_inv(i):
    """Inverse of J (same piecewise approximation)."""
    x = np.asarray(i, dtype=np.float64)
    x = np.clip(x, 1e-12, 1.0 - 1e-12)
    a, b, c = 1.09542, 0.214217, 2.33727
    d, e, f = 0.706692, 0.386013, 1.75017
    return np.where(
        x < 0.3646,
        a * x**2 + b * x + c * np.sqrt(x),
        -d * np.log(e * (1.0 - x)) + f * x,
    )


def pexit_converges(base, sigma_n, punctured_cols=(), max_iters=1000,
                    target=1.0 - 1e-6):
    """Does P-EXIT drive all edge MIs to ~1 at AWGN noise std sigma_n?

    ``base`` is an integer protomatrix (entries = edge multiplicities).
    Vectorized with bincount-based leave-one-out sums.
    """
    base = np.asarray(base)
    R, C = base.shape
    rows, cols = np.nonzero(base)
    mult = base[rows, cols]
    er = np.repeat(rows, mult)
    ec = np.repeat(cols, mult)
    nE = er.shape[0]
    punct = np.zeros(C, dtype=bool)
    for c in punctured_cols:
        punct[c] = True
    sig_ch2 = np.where(punct[ec], 0.0, (2.0 / sigma_n) ** 2)
    ch2_col = np.where(punct, 0.0, (2.0 / sigma_n) ** 2)

    I_ec = np.zeros(nE)
    for _ in range(max_iters):
        s2 = J_inv(I_ec) ** 2
        tot_v = np.bincount(ec, weights=s2, minlength=C)
        I_ev = J(np.sqrt(np.maximum(tot_v[ec] - s2, 0.0) + sig_ch2))
        t2 = J_inv(1.0 - I_ev) ** 2
        tot_c = np.bincount(er, weights=t2, minlength=R)
        I_new = 1.0 - J(np.sqrt(np.maximum(tot_c[er] - t2, 0.0)))
        done = np.allclose(I_new, I_ec, atol=1e-10)
        I_ec = I_new
        app = J(np.sqrt(tot_v + ch2_col))
        if app.min() >= target:
            return True
        if done:
            break
    return False


def pexit_threshold(base, punctured_cols=(), lo=0.5, hi=1.2, tol=1e-3,
                    max_iters=2000):
    """Binary-search the P-EXIT convergence threshold sigma* of a base."""
    while hi - lo > tol:
        mid = 0.5 * (lo + hi)
        if pexit_converges(base, mid, punctured_cols, max_iters=max_iters):
            lo = mid
        else:
            hi = mid
    return lo


# ---------------------------------------------------------------------------
# Min-sum density evolution (population dynamics / sampled DE)
#
# The Gaussian-approximation P-EXIT above is exact-BP-only: the min-sum CN
# output is NOT consistent-Gaussian (a min of folded near-Gaussians), so
# designing a code *for* normalized min-sum needs message densities tracked
# directly. Population dynamics does that without any distributional
# assumption: each protograph edge carries a population of N sampled
# messages; the VN/CN updates are applied to the samples with per-edge
# shuffling to realize the cycle-free (independence) assumption. This is
# the sampled analog of full density evolution and handles any CN rule —
# here |out| = max(alpha_d * min_other - beta, 0) with sign-product parity,
# exactly the kernel rule (ops/qc_decode.cn_update_qc_minsum).
# ---------------------------------------------------------------------------


def _resolve_alpha(alpha, degree):
    if isinstance(alpha, (int, float)):
        return float(alpha)
    table = dict(alpha)
    if degree in table:
        return float(table[degree])
    return float(table[0])


def minsum_de_run(base, sigma_n, punctured_cols=(), alpha=1.0, beta=0.0,
                  clamp=64.0, n_samples=20000, max_iters=300, seed=0,
                  alg="min-sum", stall_iters=60, target_err=0.0):
    """Sampled density evolution of (normalized/offset) min-sum on a base.

    Returns ``(converged, iters)``: whether every column's posterior error
    fraction dropped to ``target_err`` (default 0/N) within ``max_iters``
    flood iterations, and the first iteration where it did. NB the 0/N
    exit is a last-few-samples extreme-tail event with large seed-to-seed
    variance near threshold; for RANKING candidates (annealing) use a
    small positive target like 10/n_samples — once the waterfall starts,
    the gap between 1e-3 and 0 error is a few iterations, and the
    10-sample crossing is far less noisy. ``alg='sum-product'`` runs the exact tanh rule
    instead (a Monte-Carlo cross-check of the GA P-EXIT above).

    All-zero-codeword BPSK convention: channel LLR ~ N(2/sigma^2, 4/sigma^2),
    error event = negative posterior. The VN clamp mirrors the decoder's
    ``StaticParams.minsum_clamp``.
    """
    base = np.asarray(base)
    R, C = base.shape
    rows, cols = np.nonzero(base)
    mult = base[rows, cols]
    er = np.repeat(rows, mult)
    ec = np.repeat(cols, mult)
    nE = er.shape[0]
    punct = np.zeros(C, dtype=bool)
    for c in punctured_cols:
        punct[c] = True
    rng = np.random.default_rng(seed)

    row_edges = [np.flatnonzero(er == r) for r in range(R)]
    col_edges = [np.flatnonzero(ec == c) for c in range(C)]
    row_alpha = [
        _resolve_alpha(alpha, len(e)) for e in row_edges
    ]

    mu, sd = 2.0 / sigma_n**2, 2.0 / sigma_n
    # fixed channel population per column (resampling each iteration only
    # adds MC noise; the per-iteration edge shuffles provide independence)
    ch = np.zeros((C, n_samples), np.float32)
    for c in range(C):
        if not punct[c]:
            ch[c] = rng.normal(mu, sd, n_samples)

    # VN->CN message populations, one row per expanded edge
    v2c = ch[ec].copy()
    c2v = np.zeros_like(v2c)
    best_err, best_it = 1.0, 0

    for it in range(1, max_iters + 1):
        # decorrelate: independent shuffle of every edge population
        # (one vectorized call, not nE separate permutations)
        rng.permuted(v2c, axis=1, out=v2c)
        # CN update
        for r in range(R):
            e_idx = row_edges[r]
            m = v2c[e_idx]  # [d, N]
            if alg == "sum-product":
                t = np.tanh(np.clip(m, -38.0, 38.0) / 2.0)
                # leave-one-out products with EXACT zeros handled (a
                # punctured column's init messages are 0, so prod/t_k
                # would wrongly zero the LOO product of the zero edge
                # and stall the bootstrap): product over nonzeros, then
                # 0 zeros -> prod/t_k; 1 zero -> prod at the zero edge,
                # 0 elsewhere; >=2 zeros -> all 0
                is_z = t == 0.0
                nz = is_z.sum(axis=0, keepdims=True)
                t_safe = np.where(is_z, 1.0, t)
                prod_nz = np.prod(t_safe, axis=0, keepdims=True)
                loo = np.where(
                    nz == 0, prod_nz / t_safe,
                    np.where((nz == 1) & is_z, prod_nz, 0.0))
                loo = np.clip(loo, -0.9999999, 0.9999999)
                c2v[e_idx] = 2.0 * np.arctanh(loo)
                continue
            a = np.abs(m)
            sgn = np.sign(m)
            sgn[sgn == 0] = 1.0
            d = len(e_idx)
            order = np.argsort(a, axis=0)
            min1 = np.take_along_axis(a, order[0:1], axis=0)
            min2 = (np.take_along_axis(a, order[1:2], axis=0)
                    if d > 1 else np.zeros_like(min1))
            pos = order[0:1]
            prod_sgn = np.prod(sgn, axis=0, keepdims=True)
            k_idx = np.arange(d)[:, None]
            other = np.where(k_idx == pos, min2, min1)
            res = np.maximum(row_alpha[r] * other - beta, 0.0)
            c2v[e_idx] = (prod_sgn * sgn) * res
        # VN update + posterior error check
        rng.permuted(c2v, axis=1, out=c2v)
        err = 0.0
        for c in range(C):
            e_idx = col_edges[c]
            r_in = c2v[e_idx]
            tot = ch[c] + r_in.sum(axis=0)
            err = max(err, float(np.mean(tot < 0.0)))
            out = tot[None, :] - r_in
            v2c[e_idx] = np.clip(out, -clamp, clamp)
        if err <= target_err:
            return True, it
        # stall detection: no new best error in ``stall_iters`` iterations
        # means the density reached a (noisy) fixed point below threshold
        if err < best_err * 0.98:
            best_err, best_it = err, it
        elif it - best_it >= stall_iters:
            return False, max_iters
    return False, max_iters


def minsum_de_threshold(base, punctured_cols=(), alpha=1.0, beta=0.0,
                        clamp=64.0, lo=0.5, hi=1.2, tol=2e-3,
                        n_samples=20000, max_iters=300, seed=0,
                        alg="min-sum"):
    """Binary-search the sampled-DE convergence threshold sigma* of a base
    under (normalized) min-sum. MC noise makes the boundary fuzzy at the
    ~1/sqrt(n_samples) level; use >= 2e4 samples for design decisions and
    qualify the lifted code on-chip."""
    while hi - lo > tol:
        mid = 0.5 * (lo + hi)
        ok, _ = minsum_de_run(base, mid, punctured_cols, alpha, beta, clamp,
                              n_samples, max_iters, seed, alg)
        if ok:
            lo = mid
        else:
            hi = mid
    return lo
