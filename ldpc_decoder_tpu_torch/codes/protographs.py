"""Base matrices: the AR4JA and RU-irregular ensembles, random regular
bases, the flagship punctured protograph p41 and the one- and two-stage
lifts.

JAX-free copy of ``ldpc_decoder_tpu/codes/protographs.py`` with its names
and defaults (``AR4JA_RATE_12``, ``ar4ja_base``, ``ru_irregular_base``,
``regular_base``, ``prelift_base``, ``make_protograph_code_two_stage``,
``make_protograph_code``, ``P41_BASE``, ``p41_code``, ``p41_shipped_params``,
``OPTIMIZED_R12_BASE``); ``tests/test_torch_host.py`` and
``tests/test_torch_protographs.py`` hold the built bases and structures
equal. A base matrix entry m > 1 means m parallel edges between that
(check, variable) pair in the protograph; lifted with distinct circulant
shifts they become disjoint edge sets.
"""

from __future__ import annotations

import numpy as np

# AR4JA rate-1/2 protomatrix (Divsalar et al., "Capacity-Approaching
# Protograph Codes", IEEE JSAC 2009, Fig. 12). Columns:
# [v0 (transmitted), v1 (PUNCTURED, degree 6), v2, v3, v4]; the last
# column pair carries the accumulate-repeat structure.
AR4JA_RATE_12 = np.array(
    [
        [1, 2, 0, 0, 0],
        [0, 3, 1, 1, 1],
        [0, 1, 2, 2, 1],
    ],
    dtype=np.int8,
)
AR4JA_RATE_12_PUNCTURED_COLS = (1,)


def ar4ja_base(rate_num: int = 1, rate_den: int = 2):
    """AR4JA base matrix + punctured column indices for rate n/(n+2); rate
    1/2 only. A naive random lift of it has a BER floor near 1e-4 at
    n = 10^6 (small trapping sets through the parallel-edge circulants):
    lift it with :func:`make_protograph_code_two_stage`."""
    if (rate_num, rate_den) == (1, 2):
        return AR4JA_RATE_12.copy(), AR4JA_RATE_12_PUNCTURED_COLS
    raise ValueError(f"unsupported AR4JA rate {rate_num}/{rate_den}")


def ru_irregular_base(scale: int = 8, seed: int = 0):
    """Integer base matrix realizing the RU max-d_v-8 rate-1/2 ensemble.

    Edge-perspective profile (Richardson/Shokrollahi/Urbanke, "Design of
    capacity-approaching irregular LDPC codes", Table I, max d_v = 8):
    lambda(x) = 0.30013 x + 0.28395 x^2 + 0.41592 x^7,
    rho(x) = 0.22919 x^5 + 0.77081 x^6, threshold sigma* = 0.9497.
    Realized as a (3·scale) x (6·scale) 0/1 base with column degrees from
    {2, 3, 8} and row degrees from {6, 7} in the profile's node
    proportions. Returns (base, ()): no column is punctured.
    """
    R, C = 3 * scale, 6 * scale
    # node-perspective fractions: n_j ∝ λ_j / j
    lam = {2: 0.30013, 3: 0.28395, 8: 0.41592}
    node = {j: l / j for j, l in lam.items()}
    tot = sum(node.values())
    counts = {j: int(round(C * f / tot)) for j, f in node.items()}
    counts[2] += C - sum(counts.values())  # rounding slack -> deg-2
    col_deg = np.repeat(
        list(counts.keys()), list(counts.values())
    ).astype(np.int64)
    n_edges = int(col_deg.sum())
    # rows: degrees 6/7 summing to n_edges
    d7 = n_edges - 6 * R
    if not 0 <= d7 <= R:
        raise ValueError("scale incompatible with the degree profile")
    row_deg = np.array([7] * d7 + [6] * (R - d7), dtype=np.int64)

    # degree-constrained 0/1 base: place columns greedily (densest first),
    # sampling distinct rows weighted by remaining row capacity
    rng = np.random.default_rng(seed)
    order = np.argsort(-col_deg)
    for _ in range(200):
        cap = row_deg.astype(np.float64).copy()
        base = np.zeros((R, C), dtype=np.int8)
        ok = True
        for c in order:
            d = int(col_deg[c])
            if (cap > 0).sum() < d:
                ok = False
                break
            p = cap / cap.sum()
            picks = rng.choice(R, size=d, replace=False, p=p)
            base[picks, c] = 1
            cap[picks] -= 1
        if ok and (base.sum(axis=1) == row_deg).all():
            return base, ()
        rng = np.random.default_rng(rng.integers(1 << 31))
    raise RuntimeError("could not realize the degree profile; "
                       "try a larger scale")


def regular_base(R: int, C: int, dv: int, dc: int, seed: int = 0):
    """Random (dv, dc)-regular 0/1 base matrix (configuration model,
    parallel edges rejected). A sparse scaled base, not the all-ones
    dv x dc one: QC lifts of fully connected bases have minimum distance
    <= (dv+1)! whatever the lift size (MacKay/Davey bound)."""
    if R * dc != C * dv:
        raise ValueError("degree/size mismatch: R*dc must equal C*dv")
    rng = np.random.default_rng(seed)
    for _ in range(500):
        cap = np.full(R, dc, dtype=np.float64)
        base = np.zeros((R, C), dtype=np.int8)
        ok = True
        for c in range(C):
            if (cap > 0).sum() < dv:
                ok = False
                break
            picks = rng.choice(R, size=dv, replace=False, p=cap / cap.sum())
            base[picks, c] = 1
            cap[picks] -= 1
        if ok and (base.sum(axis=1) == dc).all():
            return base
        rng = np.random.default_rng(rng.integers(1 << 31))
    raise RuntimeError("could not realize a simple regular base")


def prelift_base(base, m: int, seed: int = 0, tries: int = 64):
    """First-stage lift: expand a multi-edge protograph into a 0/1 base.

    Each cell with multiplicity k becomes k size-m circulants with
    *distinct* shifts (so no parallel edges survive). Among ``tries`` random
    draws, keeps the one whose pre-lifted base has the fewest base 4-cycle
    patterns. Proto column c maps to columns [c*m, (c+1)*m), so a punctured
    proto column maps to m punctured columns.
    """
    from ldpc_decoder_tpu_torch.codes.qc import _cycle_patterns

    base = np.asarray(base)
    R, C = base.shape
    r0, c0 = np.nonzero(base)
    mult = base[r0, c0].astype(np.int64)
    if mult.max(initial=1) > m:
        raise ValueError(f"cell multiplicity {mult.max()} exceeds prelift {m}")
    rng = np.random.default_rng(seed)
    best, best_n4 = None, None
    for _ in range(tries):
        big = np.zeros((R * m, C * m), dtype=np.int8)
        z = np.arange(m)
        for r, c, k in zip(r0, c0, mult):
            shifts = rng.choice(m, size=int(k), replace=False)
            for s in shifts:
                big[r * m + z, c * m + (z + s) % m] = 1
        n4 = _cycle_patterns(big)[1].shape[0]
        if best_n4 is None or n4 < best_n4:
            best, best_n4 = big, n4
    return best


def make_protograph_code_two_stage(
    base, punctured_cols, m: int, Z: int, seed: int = 0,
    coarse=None, fine_mod: int = 4,
):
    """Two-stage girth-aware lift of a multi-edge punctured protograph:
    :func:`prelift_base`, then
    :func:`~ldpc_decoder_tpu_torch.codes.qc.make_qc_structure_repair`
    (girth >= 8). n = C*m*Z variables, of which len(punctured_cols)*m*Z are
    erased and placed last (reference convention, ldpc_code.cpp:52-76)."""
    from ldpc_decoder_tpu_torch.codes.qc import (
        make_qc_structure_repair,
        qc_to_code,
    )

    base = np.asarray(base)
    punct = sorted(punctured_cols)
    order = [c for c in range(base.shape[1]) if c not in punct] + punct
    big = prelift_base(base[:, order], m, seed=seed)
    structure = make_qc_structure_repair(
        big, Z, seed=seed, coarse=coarse, fine_mod=fine_mod
    )
    code = qc_to_code(structure, n_erased_vars=len(punct) * m * Z)
    return code, structure


def make_protograph_code(base, punctured_cols, Z: int, seed: int = 0,
                         coarse=None, fine_mod: int = 4):
    """One-stage lift of a protograph (multi-edge cells lifted with
    distinct shifts by :func:`~ldpc_decoder_tpu_torch.codes.qc.make_qc_code`)
    into (code, structure), punctured columns permuted to the end and
    marked as the last len(punctured_cols)*Z erased variables (the
    reference's alist convention, ldpc_code.cpp:52-76): never transmitted,
    recovered by decoding and counted in the error statistics."""
    from ldpc_decoder_tpu_torch.codes.qc import make_qc_code

    base = np.asarray(base)
    punct = sorted(punctured_cols)
    order = [c for c in range(base.shape[1]) if c not in punct] + punct
    return make_qc_code(base[:, order], Z, seed=seed,
                        n_erased_vars=len(punct) * Z,
                        coarse=coarse, fine_mod=fine_mod)


# The flagship punctured protograph ("p41"): 4x7 rate-1/2-over-transmitted
# base with ONE punctured column (the last, degree 8) and one degree-1
# transmitted column (see ldpc_decoder_tpu/codes/protographs.py for its
# construction and thresholds).
P41_BASE = np.array(
    [
        [0, 1, 1, 0, 1, 0, 3],
        [0, 1, 0, 1, 2, 1, 2],
        [0, 2, 0, 1, 1, 1, 1],
        [1, 0, 0, 0, 0, 0, 2],
    ],
    dtype=np.int8,
)
P41_PUNCTURED_COLS = (6,)


def p41_code(Z: int = 18432, seed: int = 3, m: int = 8,
             coarse: int | None = 1024, fine_mod: int = 64):
    """Build the flagship sigma<=0.95 punctured code (see P41_BASE).

    n = 7*m*Z total variables of which m*Z are punctured; rate 1/2 over
    transmitted bits. Defaults give the validated n = 1,032,192 instance.
    """
    return make_protograph_code_two_stage(
        P41_BASE, P41_PUNCTURED_COLS, m=m, Z=Z, seed=seed,
        coarse=coarse, fine_mod=fine_mod,
    )


def p41_shipped_params() -> dict[str, str]:
    """Construction parameters of the shipped p41 instance (the defaults
    of :func:`p41_code`), for the ``#params=`` alist cache header."""
    import inspect

    sig = inspect.signature(p41_code)
    out = {"base": "p41"}
    for k, v in sig.parameters.items():
        out[k] = str(v.default)
    return out


# P-EXIT-optimized 12x24 rate-1/2 base (RU max-d_v-8 degree profile,
# scripts/optimize_base.py: random search + degree-preserving edge-swap
# hill climb maximizing the Gaussian-approximation P-EXIT threshold).
# P-EXIT sigma* = 0.9471 (ensemble limit 0.9497; a random realization of
# the same profile scores ~0.925-0.943).
OPTIMIZED_R12_BASE = np.array(
    [[1, 0, 1, 0, 0, 0, 1, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0, 1, 0, 0, 1, 0, 0, 0], [0, 1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1], [0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 0, 0, 1, 0, 0, 1, 0, 0, 1, 1], [1, 0, 0, 0, 1, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 1, 0, 0, 1, 1], [0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 1, 1, 0, 1, 0, 0, 1, 0, 0, 1, 1, 0, 0], [0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0, 1, 0, 1, 0, 1, 1, 1, 1], [0, 0, 0, 1, 0, 0, 0, 0, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1], [0, 0, 1, 0, 0, 0, 0, 0, 0, 1, 0, 1, 0, 0, 0, 1, 0, 0, 0, 1, 0, 0, 1, 1], [0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0, 1, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0, 1], [0, 1, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 1, 0, 1, 1, 0, 0], [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 1, 0, 1, 1, 1, 1], [0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 1, 0, 0, 1, 0, 0, 1, 1, 1, 0]] , dtype=np.int8)
