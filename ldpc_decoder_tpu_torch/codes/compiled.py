"""Compilation of a Tanner graph into degree-sorted static index tables.

JAX-free copy of ``ldpc_decoder_tpu/codes/compiled.py`` (the card's host
has no JAX); ``tests/test_torch_host.py`` holds the two equal array by
array. The general path's tables (``ops/general.py``) are built from it.

The reference walks CSR offset tables with per-thread running pointers
(flood.cu:127-156, flood_vec2.cl:256-260) — a pattern that maps badly to XLA.
Instead we *sort variable nodes and check nodes by degree once* at compile
time. In the sorted space every degree-d group is contiguous, so:

- the variable-node (forward) pass is, per degree bucket, a dense
  ``reshape([count, d, B]) -> sum(axis=1)`` plus a broadcast — no gathers;
- the check-node (backward) pass is the same shape trick on the check side;
- moving messages between the two edge orders is exactly one row-gather per
  direction per iteration (``perm_v2c`` / ``perm_c2v``), the irreducible cost
  of the graph's edge permutation (reference: edge_in_to_out/edge_out_to_in,
  ldpc_code.cpp:134-149).

All tables are plain numpy int32; the decoder turns them into tensors.
Frames always occupy the trailing (lane) axis of device arrays.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ldpc_decoder_tpu_torch.codes.code import LDPCCode


@dataclass(frozen=True)
class DegreeBucket:
    degree: int
    row_start: int  # first node row in sorted node space
    count: int  # number of nodes of this degree
    edge_start: int  # first edge row in sorted edge space


def _concat_ranges(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """[s0..s0+l0) ++ [s1..s1+l1) ++ ... as one int64 index array."""
    total = int(lens.sum())
    if total == 0:
        return np.zeros((0,), dtype=np.int64)
    group_off = np.zeros(len(lens), dtype=np.int64)
    np.cumsum(lens[:-1], out=group_off[1:])
    return (
        np.arange(total, dtype=np.int64)
        + np.repeat(starts.astype(np.int64) - group_off, lens)
    )


def _buckets(sorted_degrees: np.ndarray) -> list[DegreeBucket]:
    degs, starts, counts = np.unique(
        sorted_degrees, return_index=True, return_counts=True
    )
    out = []
    edge_start = 0
    for d, s, c in zip(degs.tolist(), starts.tolist(), counts.tolist()):
        out.append(
            DegreeBucket(degree=int(d), row_start=int(s), count=int(c),
                         edge_start=edge_start)
        )
        edge_start += int(d) * int(c)
    return out


@dataclass(frozen=True)
class CompiledCode:
    """Degree-sorted static index tables for the flood decoder.

    Sorted spaces: ``vn`` rows are variables ordered by (degree, id);
    ``cn`` rows are checks ordered by (degree, id). ``vnedge``/``cnedge``
    are edges enumerated node-major in the respective sorted space, keeping
    the original within-node edge order.
    """

    code: LDPCCode

    vn_order: np.ndarray   # [n_vars] sorted-row -> natural var id
    vn_pos: np.ndarray     # [n_vars] natural var id -> sorted row
    cn_order: np.ndarray   # [n_checks]
    cn_pos: np.ndarray     # [n_checks]

    perm_v2c: np.ndarray   # [E] cnedge t -> vnedge carrying the same edge
    perm_c2v: np.ndarray   # [E] vnedge s -> cnedge carrying the same edge
    cn_edge_vnrow: np.ndarray  # [E] cnedge t -> sorted vn row of its variable

    vn_buckets: tuple[DegreeBucket, ...]
    cn_buckets: tuple[DegreeBucket, ...]

    @property
    def n_vars(self) -> int:
        return self.code.n_vars

    @property
    def n_checks(self) -> int:
        return self.code.n_checks

    @property
    def n_edges(self) -> int:
        return self.code.n_edges


def compile_code(code: LDPCCode) -> CompiledCode:
    if code.var_degrees.min(initial=1) < 1:
        raise ValueError("degree-0 variables are not supported")
    if code.check_degrees.min(initial=1) < 1:
        raise ValueError("degree-0 checks are not supported")

    vn_order = np.argsort(code.var_degrees, kind="stable").astype(np.int32)
    cn_order = np.argsort(code.check_degrees, kind="stable").astype(np.int32)
    vn_pos = np.empty_like(vn_order)
    vn_pos[vn_order] = np.arange(code.n_vars, dtype=np.int32)
    cn_pos = np.empty_like(cn_order)
    cn_pos[cn_order] = np.arange(code.n_checks, dtype=np.int32)

    # vnedge s -> original in-edge, cnedge t -> original out-edge
    vnedge_to_inedge = _concat_ranges(
        code.in_bit_to_edge[vn_order], code.var_degrees[vn_order]
    )
    cnedge_to_outedge = _concat_ranges(
        code.out_bit_to_edge[cn_order], code.check_degrees[cn_order]
    )
    n_edges = code.n_edges
    inedge_to_vnedge = np.empty(n_edges, dtype=np.int64)
    inedge_to_vnedge[vnedge_to_inedge] = np.arange(n_edges, dtype=np.int64)
    outedge_to_cnedge = np.empty(n_edges, dtype=np.int64)
    outedge_to_cnedge[cnedge_to_outedge] = np.arange(n_edges, dtype=np.int64)

    perm_v2c = inedge_to_vnedge[
        code.edge_out_to_in[cnedge_to_outedge]
    ].astype(np.int32)
    perm_c2v = outedge_to_cnedge[
        code.edge_in_to_out[vnedge_to_inedge]
    ].astype(np.int32)
    cn_edge_vnrow = vn_pos[
        code.in_edge_to_bit[code.edge_out_to_in[cnedge_to_outedge]]
    ].astype(np.int32)

    return CompiledCode(
        code=code,
        vn_order=vn_order,
        vn_pos=vn_pos,
        cn_order=cn_order,
        cn_pos=cn_pos,
        perm_v2c=perm_v2c,
        perm_c2v=perm_c2v,
        cn_edge_vnrow=cn_edge_vnrow,
        vn_buckets=tuple(_buckets(code.var_degrees[vn_order])),
        cn_buckets=tuple(_buckets(code.check_degrees[cn_order])),
    )
