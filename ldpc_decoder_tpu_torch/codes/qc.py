"""Quasi-cyclic (protograph-lifted) LDPC codes.

JAX-free copy of ``ldpc_decoder_tpu/codes/qc.py``: :class:`QCStructure`,
the rejection lift (:func:`make_qc_structure`, :func:`make_qc_code`) and
the girth repair lift, :func:`qc_to_code`, the alist cache helpers, and QC
detection on plain alists (:func:`detect_qc_structure`,
:func:`detect_qc_structure_permuted`, :func:`qc_cover_stats`,
:func:`interleave_code_numbering`). ``tests/test_torch_host.py`` and
``tests/test_torch_qc_detect.py`` hold the copies equal.

Conventions:
- variable (j, z) has natural id j*Z + z; check (r, z) id r*Z + z;
- a base edge (r, j) with shift s connects check (r, z) to variable
  (j, (z + s) mod Z) for all z.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from ldpc_decoder_tpu_torch.codes.alist import AlistData
from ldpc_decoder_tpu_torch.codes.code import LDPCCode


@dataclass(frozen=True)
class QCStructure:
    """Base-graph metadata of a lifted code."""

    Z: int
    n_base_rows: int
    n_base_cols: int
    # [n_base_edges] int32 each, sorted by (row, col): one entry per circulant
    edge_row: np.ndarray
    edge_col: np.ndarray
    edge_shift: np.ndarray

    @property
    def n_base_edges(self) -> int:
        return int(self.edge_row.shape[0])

    def row_degrees(self) -> np.ndarray:
        return np.bincount(self.edge_row, minlength=self.n_base_rows)

    def col_degrees(self) -> np.ndarray:
        return np.bincount(self.edge_col, minlength=self.n_base_cols)

    def header_tokens(self) -> list[str]:
        """Serialize into alist comment headers (ignored by the reference's
        parser, ldpc_code.cpp:52-76)."""
        edges = ",".join(
            f"{r}:{c}:{s}"
            for r, c, s in zip(
                self.edge_row.tolist(),
                self.edge_col.tolist(),
                self.edge_shift.tolist(),
            )
        )
        return [
            f"#qc={self.Z};{self.n_base_rows};{self.n_base_cols}",
            f"#qcedges={edges}",
        ]

    @staticmethod
    def from_header(text: str) -> "QCStructure | None":
        qc = edges = None
        for line in text.splitlines():
            line = line.strip()
            if line.startswith("#qc="):
                qc = line[4:]
            elif line.startswith("#qcedges="):
                edges = line[9:]
            elif not line.startswith("#"):
                break
        if qc is None or edges is None:
            return None
        Z, R, C = (int(x) for x in qc.split(";"))
        triples = [tuple(int(x) for x in e.split(":")) for e in edges.split(",")]
        arr = np.array(triples, dtype=np.int32)
        return QCStructure(
            Z=Z, n_base_rows=R, n_base_cols=C,
            edge_row=arr[:, 0], edge_col=arr[:, 1], edge_shift=arr[:, 2],
        )


def _has_4cycle(structure: QCStructure) -> bool:
    """4-cycle test, multi-edge aware: a lifted 4-cycle exists iff two
    distinct (edge, edge) pairs bridging the same row pair give equal shift
    differences mod Z; parallel edges within a cell also close same-row
    cycles when two in-cell differences coincide (or shifts repeat)."""
    from collections import defaultdict

    R, C, Z = structure.n_base_rows, structure.n_base_cols, structure.Z
    cell = defaultdict(list)
    for r, c, sh in zip(structure.edge_row.tolist(),
                        structure.edge_col.tolist(),
                        structure.edge_shift.tolist()):
        cell[(r, c)].append(sh)
    for ss in cell.values():
        if len(set(ss)) < len(ss):  # collapsed parallel edge
            return True
    for r in range(R):  # same-row pair differences (multi-edge cells)
        diffs = []
        for c in range(C):
            ss = cell.get((r, c), [])
            for i in range(len(ss)):
                for j in range(len(ss)):
                    if i != j:
                        diffs.append((ss[i] - ss[j]) % Z)
        if len(diffs) != len(set(diffs)):
            return True
    for r1 in range(R):  # cross-row-pair differences
        for r2 in range(r1 + 1, R):
            diffs = []
            for c in range(C):
                for s1 in cell.get((r1, c), []):
                    for s2 in cell.get((r2, c), []):
                        diffs.append((s1 - s2) % Z)
            if len(diffs) != len(set(diffs)):
                return True
    return False


def _count_6cycles(structure: QCStructure) -> int:
    """Number of base 6-cycle patterns whose shift condition closes (each
    gives Z lifted six-cycles); every cycle is counted a constant number of
    times, which is enough for rejection."""
    from itertools import combinations, permutations

    R, C, Z = structure.n_base_rows, structure.n_base_cols, structure.Z
    S = np.full((R, C), -1, dtype=np.int64)
    S[structure.edge_row, structure.edge_col] = structure.edge_shift
    count = 0
    cols = np.arange(C)
    for rows in combinations(range(R), 3):
        for r1, r2, r3 in permutations(rows):
            if (r1, r2, r3)[0] != min(r1, r2, r3):
                continue  # fix rotation symmetry
            c1, c2, c3 = np.meshgrid(cols, cols, cols, indexing="ij")
            distinct = (c1 != c2) & (c2 != c3) & (c1 != c3)
            ok = (
                (S[r1, c1] >= 0) & (S[r1, c2] >= 0)
                & (S[r2, c2] >= 0) & (S[r2, c3] >= 0)
                & (S[r3, c3] >= 0) & (S[r3, c1] >= 0)
                & distinct
            )
            d = (
                S[r1, c1] - S[r1, c2] + S[r2, c2] - S[r2, c3]
                + S[r3, c3] - S[r3, c1]
            ) % Z
            count += int(((d == 0) & ok).sum())
    return count


def _cycle_patterns(base01: np.ndarray):
    """Enumerate the base-graph 4- and 6-cycle patterns of a 0/1 base.

    Returns ``(edge_id, p4, p6)``: ``edge_id[r, c]`` maps cells to edge
    indices in row-major (np.nonzero) order; ``p4 [n4, 4]`` / ``p6 [n6, 6]``
    hold the edge indices of each pattern in alternating-sign walk order, so
    a pattern's lifted cycles close iff the alternating sum of its shifts is
    0 mod Z (the classic Fossorier condition, generalized to 6-cycles).
    """
    base01 = np.asarray(base01)
    R, C = base01.shape
    if (base01 > 1).any():
        raise ValueError("_cycle_patterns supports 0/1 bases only")
    edge_id = np.full((R, C), -1, dtype=np.int64)
    rows, cols = np.nonzero(base01)
    edge_id[rows, cols] = np.arange(rows.shape[0])
    nbr = [np.nonzero(base01[r])[0] for r in range(R)]

    p4 = []
    for r1 in range(R):
        for r2 in range(r1 + 1, R):
            shared = np.intersect1d(nbr[r1], nbr[r2], assume_unique=True)
            for i in range(len(shared)):
                for j in range(i + 1, len(shared)):
                    c1, c2 = shared[i], shared[j]
                    p4.append((edge_id[r1, c1], edge_id[r2, c1],
                               edge_id[r2, c2], edge_id[r1, c2]))

    p6 = []
    for r1 in range(R):
        for r2 in range(r1 + 1, R):
            s12 = np.intersect1d(nbr[r1], nbr[r2], assume_unique=True)
            if not len(s12):
                continue
            for r3 in range(r2 + 1, R):
                # cycle r1-c1-r2-c2-r3-c3-r1 with r1 < r2 < r3: any cyclic
                # order of 3 rows uses the same three row-pair slots, and
                # reversal (the only other traversal) negates the shift sum
                # — so this enumerates each geometric 6-cycle exactly once.
                s23 = np.intersect1d(nbr[r2], nbr[r3], assume_unique=True)
                s31 = np.intersect1d(nbr[r3], nbr[r1], assume_unique=True)
                if not len(s23) or not len(s31):
                    continue
                c1g, c2g, c3g = np.meshgrid(s12, s23, s31, indexing="ij")
                ok = (c1g != c2g) & (c2g != c3g) & (c1g != c3g)
                for c1, c2, c3 in zip(c1g[ok], c2g[ok], c3g[ok]):
                    p6.append((edge_id[r1, c1], edge_id[r2, c1],
                               edge_id[r2, c2], edge_id[r3, c2],
                               edge_id[r3, c3], edge_id[r1, c3]))
    return (
        edge_id,
        np.array(p4, dtype=np.int64).reshape(-1, 4),
        np.array(p6, dtype=np.int64).reshape(-1, 6),
    )


_COEF4 = np.array([1, -1, 1, -1], dtype=np.int64)
_COEF6 = np.array([1, -1, 1, -1, 1, -1], dtype=np.int64)


def make_qc_structure_repair(
    base: np.ndarray, Z: int, seed: int = 0,
    coarse: int | None = None, fine_mod: int = 4,
    weight4: int = 10_000, max_moves: int = 40_000,
    allow_residual_6cycles: bool = False,
) -> QCStructure:
    """Girth-8 lift via targeted shift repair (CCSDS 131.1-style goal).

    Samples lattice shifts, then iteratively resamples the edge involved in
    the most closed 4-/6-cycle patterns, choosing the candidate shift that
    minimizes its closures (4-cycles weighted ``weight4``). Each move only
    re-evaluates the patterns touching one edge.

    Raises RuntimeError if violations cannot be driven to zero.
    """
    base = np.asarray(base)
    rng = np.random.default_rng(seed)
    edge_id, p4, p6 = _cycle_patterns(base)
    rows, cols = np.nonzero(base)
    nE = rows.shape[0]
    if coarse is not None:
        if Z % coarse:
            raise ValueError(f"Z={Z} not divisible by coarse={coarse}")
        if not 1 <= fine_mod <= coarse // 2:
            raise ValueError("fine_mod must be in [1, coarse/2]")

    def sample(n):
        if coarse is None:
            return rng.integers(0, Z, size=n).astype(np.int64)
        a = rng.integers(0, Z // coarse, size=n)
        b = rng.integers(-(fine_mod - 1), fine_mod, size=n)
        return ((a * coarse + b) % Z).astype(np.int64)

    # pattern -> edges bookkeeping
    pats = [(p4, _COEF4, weight4), (p6, _COEF6, 1)]
    edge_pats = [[] for _ in range(nE)]  # (pat_set, pat_row, pos)
    for si, (P, _, _) in enumerate(pats):
        for pi in range(P.shape[0]):
            for pos in range(P.shape[1]):
                edge_pats[P[pi, pos]].append((si, pi, pos))

    s = sample(nE)

    def closed_mask(P, coef):
        if P.shape[0] == 0:
            return np.zeros(0, dtype=bool)
        return (s[P] * coef).sum(axis=1) % Z == 0

    masks = [closed_mask(P, c) for P, c, _ in pats]

    def edge_scores():
        sc = np.zeros(nE, dtype=np.int64)
        for (P, _, w), m in zip(pats, masks):
            if m.any():
                np.add.at(sc, P[m].reshape(-1), w)
        return sc

    for move in range(max_moves):
        total = sum(int(m.sum()) for m in masks)
        if total == 0:
            return QCStructure(
                Z=Z, n_base_rows=base.shape[0], n_base_cols=base.shape[1],
                edge_row=rows.astype(np.int32), edge_col=cols.astype(np.int32),
                edge_shift=s.astype(np.int32),
            )
        sc = edge_scores()
        # random pick among the worst few edges (breaks repair cycles)
        top = np.argsort(-sc)[:4]
        e = int(rng.choice(top[sc[top] > 0]))
        cands = np.unique(sample(96))
        # evaluate only the patterns touching e, per candidate
        entries = edge_pats[e]
        best_c, best_v = None, None
        # partial sums excluding e's own term, per touching pattern
        part = []
        for si, pi, pos in entries:
            P, coef, w = pats[si]
            tot = int((s[P[pi]] * coef).sum() - s[e] * coef[pos])
            part.append((tot, int(coef[pos]), w))
        part = np.array(part, dtype=np.int64).reshape(-1, 3)
        v = (
            ((part[:, 0][None, :] + cands[:, None] * part[:, 1][None, :])
             % Z == 0) * part[:, 2][None, :]
        ).sum(axis=1)
        j = int(np.argmin(v + rng.random(v.shape[0]) * 0.5))
        best_c, best_v = int(cands[j]), int(v[j])
        cur_v = sum(
            w * int((s[pats[si][0][pi]] * pats[si][1]).sum() % Z == 0)
            for si, pi, pos in entries
            for w in (pats[si][2],)
        )
        if best_v <= cur_v:
            s[e] = best_c
            # update masks for touched patterns
            for si, pi, pos in entries:
                P, coef, _ = pats[si]
                masks[si][pi] = (s[P[pi]] * coef).sum() % Z == 0
    if allow_residual_6cycles and not masks[0].any():
        # small/mid lift sizes can lack the lattice freedom for girth 8;
        # a handful of residual 6-cycles is acceptable for waterfall
        # *evaluation* codes (never for shipped production codes)
        import warnings

        warnings.warn(
            f"girth repair left {int(masks[1].sum())} closed 6-cycle "
            f"patterns (girth 6) after {max_moves} moves"
        )
        return QCStructure(
            Z=Z, n_base_rows=base.shape[0], n_base_cols=base.shape[1],
            edge_row=rows.astype(np.int32), edge_col=cols.astype(np.int32),
            edge_shift=s.astype(np.int32),
        )
    raise RuntimeError(
        f"girth repair did not converge in {max_moves} moves "
        f"(residual violations: {[int(m.sum()) for m in masks]})"
    )


def make_qc_structure(
    base: np.ndarray, Z: int, seed: int = 0, max_tries: int = 200,
    coarse: int | None = None, fine_mod: int = 4, min_girth: int = 6,
) -> QCStructure:
    """Random circulant shifts for a base matrix, rejecting 4-cycles (and,
    with ``min_girth=8``, closed 6-cycle patterns of a 0/1 base).

    With ``coarse``, shifts lie on the lattice s = a*coarse + b (mod Z),
    |b| < ``fine_mod`` (the JAX package's seam-mode co-design; the port's
    kernels take any shift). Entries > 1 become parallel edges.
    """
    base = np.asarray(base)
    r0, c0 = np.nonzero(base)
    mult = base[r0, c0].astype(np.int64)
    rows = np.repeat(r0, mult)
    cols = np.repeat(c0, mult)
    rng = np.random.default_rng(seed)
    if coarse is not None:
        if Z % coarse:
            raise ValueError(f"Z={Z} not divisible by coarse={coarse}")
        if not 1 <= fine_mod <= coarse // 2:
            raise ValueError("fine_mod must be in [1, coarse/2]")
    for _ in range(max_tries):
        if coarse is None:
            shifts = rng.integers(0, Z, size=rows.shape[0]).astype(np.int32)
        else:
            a = rng.integers(0, Z // coarse, size=rows.shape[0])
            b = rng.integers(-(fine_mod - 1), fine_mod, size=rows.shape[0])
            shifts = ((a * coarse + b) % Z).astype(np.int32)
        s = QCStructure(
            Z=Z, n_base_rows=base.shape[0], n_base_cols=base.shape[1],
            edge_row=rows.astype(np.int32), edge_col=cols.astype(np.int32),
            edge_shift=shifts,
        )
        if _has_4cycle(s):
            continue
        if min_girth >= 8:
            if (base > 1).any():
                raise ValueError(
                    "min_girth=8 rejection supports 0/1 bases only")
            if _count_6cycles(s) > 0:
                continue
        return s
    raise RuntimeError(
        f"could not find girth-{min_girth} shifts for Z={Z} "
        f"(base too dense for this lift size / lattice)")


def make_qc_code(
    base: np.ndarray, Z: int, seed: int = 0, n_erased_vars: int = 0,
    coarse: int | None = None, fine_mod: int = 4, min_girth: int = 6,
) -> tuple[LDPCCode, QCStructure]:
    structure = make_qc_structure(base, Z, seed, coarse=coarse,
                                  fine_mod=fine_mod, min_girth=min_girth)
    return qc_to_code(structure, n_erased_vars), structure


def qc_to_code(structure: QCStructure, n_erased_vars: int = 0) -> LDPCCode:
    """Expand a QC structure into a full LDPCCode (vectorized)."""
    Z = structure.Z
    R, C = structure.n_base_rows, structure.n_base_cols
    n_checks, n_vars = R * Z, C * Z
    row_deg = structure.row_degrees()

    # check-major adjacency: checks ordered (r, z); within check (r, z),
    # slots ordered by base-edge order (sorted by col within a row)
    order = np.lexsort((structure.edge_col, structure.edge_row))
    e_col = structure.edge_col[order].astype(np.int64)
    e_shift = structure.edge_shift[order].astype(np.int64)

    z = np.arange(Z, dtype=np.int64)
    # for each check row r: blocks of that row -> [deg_r] per z
    adjacency = np.empty(structure.n_base_edges * Z, dtype=np.int32)
    check_degrees = np.repeat(row_deg.astype(np.int32), Z)
    pos = 0
    e_idx = 0
    for r in range(R):
        d = int(row_deg[r])
        cols_r = e_col[e_idx : e_idx + d]
        shifts_r = e_shift[e_idx : e_idx + d]
        # adj[(z, k)] = cols_r[k]*Z + (z + shifts_r[k]) % Z
        block = cols_r[None, :] * Z + (z[:, None] + shifts_r[None, :]) % Z
        adjacency[pos : pos + d * Z] = block.reshape(-1)
        pos += d * Z
        e_idx += d

    data = AlistData(
        n_checks=n_checks,
        n_vars=n_vars,
        check_degrees=check_degrees,
        var_degrees=np.repeat(
            structure.col_degrees().astype(np.int32), Z
        ),
        check_adjacency=adjacency,
        n_erased_vars=n_erased_vars,
    )
    return LDPCCode.from_alist_data(data)


def write_qc_alist(
    code: LDPCCode, structure: QCStructure, path: str,
    params: dict | None = None,
) -> None:
    """alist with QC metadata headers (reference-parser compatible).

    ``params``: construction parameters recorded as a ``#params=`` comment
    so a cached file is self-describing (a stale construction is detected
    by comparing headers, not trusted by filename)."""
    from ldpc_decoder_tpu_torch.codes.alist import write_alist

    body = write_alist(code.to_alist_data())
    with open(path, "w") as f:
        if params:
            kv = ";".join(f"{k}={v}" for k, v in sorted(params.items()))
            f.write(f"#params={kv}\n")
        for tok in structure.header_tokens():
            f.write(tok + "\n")
        f.write(body)


def read_alist_params(path: str) -> dict[str, str] | None:
    """The ``#params=`` construction header of an alist file, if present."""
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line.startswith("#params="):
                out = {}
                for kv in line[8:].split(";"):
                    if "=" in kv:
                        k, v = kv.split("=", 1)
                        out[k] = v
                return out
            if not line.startswith("#"):
                break
    return None


def load_qc_alist(path: str) -> tuple[LDPCCode, QCStructure | None]:
    with open(path) as f:
        text = f.read()
    return LDPCCode.from_alist(text), QCStructure.from_header(text)


# ---- QC detection on plain alists (ldpc_decoder_tpu/codes/qc.py:515-739) ----

def _edge_endpoints(code: LDPCCode) -> tuple[np.ndarray, np.ndarray]:
    """(check, variable) of every edge, in check-major order."""
    rows = np.repeat(
        np.arange(code.n_checks, dtype=np.int64), np.diff(code.out_bit_to_edge))
    cols = code.in_edge_to_bit[code.edge_out_to_in].astype(np.int64)
    return rows, cols


def _lift_candidates(code: LDPCCode, min_Z: int, require_tile: int):
    """Candidate lifting sizes in the JAX search order: for the power-of-two
    floor ``require_tile``, then 32, the divisors Z >= ``min_Z`` of
    gcd(n_vars, n_checks), largest first, whose largest power-of-two
    divisor reaches the floor. (The port's kernels take any Z; the search
    is kept so that both packages pick the same structure.)"""
    g = math.gcd(code.n_vars, code.n_checks)
    divisors = sorted(
        {d for i in range(1, int(math.isqrt(g)) + 1) if g % i == 0
         for d in (i, g // i)},
        reverse=True,
    )

    def pow2_div(z):
        p = 1
        while z % (p * 2) == 0:
            p *= 2
        return p

    for want_pow2 in (require_tile, 32):
        for Z in divisors:
            if Z < min_Z or Z == 1 or pow2_div(Z) < want_pow2:
                continue
            yield Z


def _try_qc_at(rows, cols, n_v, n_c, Z) -> QCStructure | None:
    """One-Z circulant test over explicit (check, var) edge endpoints: the
    code is QC at Z iff every (block row, block col, (c − r) mod Z) group
    holds exactly Z edges (a full circulant)."""
    br = rows // Z
    bc = cols // Z
    shift = (cols % Z - rows % Z) % Z
    Cb = n_v // Z
    key = (br * Cb + bc) * Z + shift
    uk, counts = np.unique(key, return_counts=True)
    if not (counts == Z).all():
        return None
    e_shift = (uk % Z).astype(np.int32)
    e_bc = ((uk // Z) % Cb).astype(np.int32)
    e_br = (uk // (Z * Cb)).astype(np.int32)
    order = np.lexsort((e_bc, e_br))
    return QCStructure(
        Z=int(Z), n_base_rows=n_c // Z, n_base_cols=Cb,
        edge_row=e_br[order], edge_col=e_bc[order],
        edge_shift=e_shift[order],
    )


def detect_qc_structure(
    code: LDPCCode, min_Z: int = 32, require_tile: int = 128
) -> QCStructure | None:
    """Recover circulant (QC) block structure from a plain code in the
    aligned layout (variable (j, z) at j·Z + z, check (r, z) at r·Z + z):
    the first candidate Z (see :func:`_lift_candidates`) at which every
    block is a full circulant. Returns None when no usable Z exists (e.g.
    random codes)."""
    rows, cols = _edge_endpoints(code)
    for Z in _lift_candidates(code, min_Z, require_tile):
        s = _try_qc_at(rows, cols, code.n_vars, code.n_checks, Z)
        if s is not None:
            return s
    return None


def detect_qc_structure_permuted(
    code: LDPCCode, min_Z: int = 32, require_tile: int = 128
):
    """Detect QC structure hidden by a block-INTERLEAVED node numbering
    (node (b, j) at index j·n_blocks + b, the lift-index-first order many
    tools emit), on variables and checks together or on one side only.

    Returns ``(QCStructure, perm_v, perm_c)``, where perm_v[u] is the
    aligned index of user variable u (identity arrays on a side that was
    already aligned), or None. The aligned layout is
    :func:`detect_qc_structure`'s job: run that first."""
    n_v, n_c = code.n_vars, code.n_checks
    rows, cols = _edge_endpoints(code)

    def interleave_perm(n, Z):
        # user index u = j*nb + b  ->  aligned b*Z + j
        nb = n // Z
        u = np.arange(n, dtype=np.int64)
        return (u % nb) * Z + u // nb

    for Z in _lift_candidates(code, min_Z, require_tile):
        ident_v = np.arange(n_v, dtype=np.int64)
        ident_c = np.arange(n_c, dtype=np.int64)
        pv = interleave_perm(n_v, Z)
        pc = interleave_perm(n_c, Z)
        for perm_v, perm_c in ((pv, pc), (pv, ident_c), (ident_v, pc)):
            s = _try_qc_at(perm_c[rows], perm_v[cols], n_v, n_c, Z)
            if s is not None:
                return s, perm_v.astype(np.int32), perm_c.astype(np.int32)
    return None


def qc_cover_stats(code: LDPCCode, max_candidates: int = 8,
                   min_fill: float = 1.0):
    """Rotatable circulant cover fraction per candidate Z: an edge is
    covered iff its diagonal ((c − r) mod Z within its cell) carries at
    least ``min_fill``·Z edges. A QC code scores 1.0, a random code ~0.
    Returns [(Z, cover_fraction), ...] best-first."""
    n_v, n_c = code.n_vars, code.n_checks
    g = math.gcd(n_v, n_c)
    divisors = [d for d in sorted(
        {d for i in range(1, int(math.isqrt(g)) + 1) if g % i == 0
         for d in (i, g // i)}, reverse=True) if 32 <= d < min(n_v, n_c)]
    rows, cols = _edge_endpoints(code)
    out = []
    for Z in divisors[:max_candidates]:
        Cb = n_v // Z
        key = ((rows // Z) * Cb + cols // Z) * Z + (cols % Z - rows % Z) % Z
        _, counts = np.unique(key, return_counts=True)
        full = counts[counts >= min_fill * Z]
        out.append((int(Z), float(full.sum() / rows.size)))
    out.sort(key=lambda t: -t[1])
    return out


def interleave_code_numbering(code: LDPCCode, Z: int) -> tuple[
        LDPCCode, np.ndarray, np.ndarray]:
    """Renumber an aligned (b·Z + j) code to interleaved (j·nb + b), the
    inverse of :func:`detect_qc_structure_permuted`'s renumbering. Returns
    (new code, to_new_v, to_new_c) with to_new_*[aligned_index] =
    new_index."""
    nb_v = code.n_vars // Z
    nb_c = code.n_checks // Z
    a_v = np.arange(code.n_vars, dtype=np.int64)
    a_c = np.arange(code.n_checks, dtype=np.int64)
    to_new_v = (a_v % Z) * nb_v + a_v // Z
    to_new_c = (a_c % Z) * nb_c + a_c // Z
    rows, cols = _edge_endpoints(code)
    nr = to_new_c[rows]
    nc = to_new_v[cols]
    order = np.lexsort((nc, nr))
    data = AlistData(
        n_checks=code.n_checks, n_vars=code.n_vars,
        check_degrees=np.bincount(
            nr, minlength=code.n_checks).astype(np.int32),
        var_degrees=np.bincount(
            nc, minlength=code.n_vars).astype(np.int32),
        check_adjacency=nc[order].astype(np.int32),
    )
    return LDPCCode.from_alist_data(data), to_new_v, to_new_c
