"""Random irregular LDPC code generation.

JAX-free copy of ``ldpc_decoder_tpu/codes/generate.py`` (the card's host
has no JAX); ``tests/test_torch_host.py`` holds the two equal: the same
seed gives the identical adjacency.

The reference ships two pre-built 2^20-bit alist codes but no generator
(README.md:109-115), and the alist blobs are absent from the snapshot — so
this framework provides its own: a vectorized configuration-model sampler for
arbitrary node-degree profiles, with duplicate-edge repair. Degree profiles
can come from the JAX package's ``codes/density_evolution.py``, which
designs capacity-approaching profiles for a target rate/noise.

All construction is numpy-vectorized so million-bit codes build in seconds.
"""

from __future__ import annotations

import numpy as np

from ldpc_decoder_tpu_torch.codes.alist import AlistData
from ldpc_decoder_tpu_torch.codes.code import LDPCCode


def _realize_degrees(
    n_nodes: int, degrees: np.ndarray, probs: np.ndarray
) -> np.ndarray:
    """Integer per-degree node counts approximating a node-perspective pmf."""
    probs = np.asarray(probs, dtype=np.float64)
    probs = probs / probs.sum()
    counts = np.floor(probs * n_nodes).astype(np.int64)
    # distribute the remainder by largest fractional part
    frac = probs * n_nodes - counts
    for i in np.argsort(-frac)[: n_nodes - int(counts.sum())]:
        counts[i] += 1
    out = np.repeat(np.asarray(degrees, dtype=np.int64), counts)
    assert out.shape[0] == n_nodes
    return out


def _match_edge_counts(
    var_deg: np.ndarray, check_deg: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Nudge node degrees so both sides have the same edge total."""
    var_deg = var_deg.copy()
    check_deg = check_deg.copy()
    diff = int(var_deg.sum() - check_deg.sum())
    if diff > 0:
        # raise the lowest-degree checks by one
        idx = np.argsort(check_deg)[:diff]
        check_deg[idx] += 1
    elif diff < 0:
        idx = np.argsort(var_deg)[: -diff]
        var_deg[idx] += 1
    return var_deg, check_deg


def make_irregular_code(
    n_vars: int,
    n_checks: int,
    var_degree_pmf: dict[int, float],
    check_degree_pmf: dict[int, float],
    seed: int = 0,
    n_erased_vars: int = 0,
    max_dup_rounds: int = 200,
) -> LDPCCode:
    """Sample a random Tanner graph from node-perspective degree pmfs.

    Uses the configuration model: variable sockets are matched with a random
    permutation against check sockets; duplicate edges are repaired by
    re-shuffling only the offending sockets until the multigraph is simple.
    """
    rng = np.random.default_rng(seed)
    vd = np.array(sorted(var_degree_pmf), dtype=np.int64)
    vp = np.array([var_degree_pmf[int(d)] for d in vd])
    cd = np.array(sorted(check_degree_pmf), dtype=np.int64)
    cp = np.array([check_degree_pmf[int(d)] for d in cd])

    var_deg = _realize_degrees(n_vars, vd, vp)
    check_deg = _realize_degrees(n_checks, cd, cp)
    rng.shuffle(var_deg)
    rng.shuffle(check_deg)
    var_deg, check_deg = _match_edge_counts(var_deg, check_deg)
    n_edges = int(var_deg.sum())

    var_sockets = np.repeat(np.arange(n_vars, dtype=np.int64), var_deg)
    check_sockets = np.repeat(np.arange(n_checks, dtype=np.int64), check_deg)
    perm = rng.permutation(n_edges)
    pair_var = var_sockets[perm]  # pair_var[i] connects to check_sockets[i]

    # Repair duplicate (check, var) pairs by re-shuffling the duplicates'
    # variable endpoints among themselves (plus a few random extras to
    # guarantee progress).
    for _ in range(max_dup_rounds):
        key = check_sockets.astype(np.int64) * n_vars + pair_var
        order = np.argsort(key, kind="stable")
        sorted_key = key[order]
        dup_mask_sorted = np.zeros(n_edges, dtype=bool)
        dup_mask_sorted[1:] = sorted_key[1:] == sorted_key[:-1]
        n_dup = int(dup_mask_sorted.sum())
        if n_dup == 0:
            break
        dup_idx = order[dup_mask_sorted]
        extra = rng.choice(n_edges, size=min(n_edges, 2 * n_dup + 8),
                           replace=False)
        idx = np.unique(np.concatenate([dup_idx, extra]))
        pair_var[idx] = pair_var[idx][rng.permutation(len(idx))]
    else:
        raise RuntimeError("could not remove duplicate edges")

    # assemble check-major adjacency
    order = np.argsort(check_sockets, kind="stable")
    adjacency = pair_var[order].astype(np.int32)
    data = AlistData(
        n_checks=n_checks,
        n_vars=n_vars,
        check_degrees=np.diff(
            np.searchsorted(check_sockets[order], np.arange(n_checks + 1))
        ).astype(np.int32),
        var_degrees=np.bincount(pair_var, minlength=n_vars).astype(np.int32),
        check_adjacency=adjacency,
        n_erased_vars=n_erased_vars,
    )
    return LDPCCode.from_alist_data(data)


def make_regular_code(
    n_vars: int, dv: int, dc: int, seed: int = 0
) -> LDPCCode:
    """A (dv, dc)-regular code; n_checks = n_vars * dv / dc."""
    if (n_vars * dv) % dc:
        raise ValueError("n_vars * dv must be divisible by dc")
    n_checks = n_vars * dv // dc
    return make_irregular_code(
        n_vars, n_checks, {dv: 1.0}, {dc: 1.0}, seed=seed
    )
