"""Base matrices: the flagship punctured protograph p41 and its two-stage
lift, and random regular bases.

JAX-free copy of part of ``ldpc_decoder_tpu/codes/protographs.py``
(``regular_base``, ``prelift_base``, ``make_protograph_code_two_stage``,
``P41_BASE``, ``p41_code``, ``p41_shipped_params``);
``tests/test_torch_host.py`` holds the built bases and structures equal. A
base matrix entry m > 1 means m parallel edges between that (check,
variable) pair in the protograph.
"""

from __future__ import annotations

import numpy as np


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
