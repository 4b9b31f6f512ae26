"""LDPC code representation: Tanner graph index tables.

JAX-free copy of ``ldpc_decoder_tpu/codes/code.py`` (the card's host has no
JAX); ``tests/test_torch_host.py`` holds the two equal. The reference's
``ldpc_code`` (h/ldpc_code.h:10-62, src/ldpc_code.cpp:45-152) as six
vectorized numpy index tables in an immutable dataclass.

Terminology (kept from the reference so citations line up):

- "inputs"/"in bits"  = variable nodes (codeword bits), count ``n_vars``
- "outputs"/"out bits" = check nodes (parity bits), count ``n_checks``
- "in edge" index: variable-major edge enumeration
- "out edge" index: check-major edge enumeration
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import cached_property

import numpy as np

from ldpc_decoder_tpu_torch.codes.alist import AlistData, parse_alist, write_alist


@dataclass(frozen=True)
class LDPCCode:
    """An irregular LDPC code over GF(2), as a bipartite Tanner graph.

    Index tables (all int32, mirroring h/ldpc_code.h:13-20):

    - ``in_bit_to_edge``:  [n_vars+1]   CSR offsets of variable-major edges
    - ``out_bit_to_edge``: [n_checks+1] CSR offsets of check-major edges
    - ``in_edge_to_bit``:  [n_edges]    variable index of each in-edge
    - ``out_edge_to_bit``: [n_edges]    check index of each out-edge
    - ``edge_in_to_out``:  [n_edges]    permutation in-edge -> out-edge
    - ``edge_out_to_in``:  [n_edges]    permutation out-edge -> in-edge
    """

    n_vars: int
    n_checks: int
    in_bit_to_edge: np.ndarray
    out_bit_to_edge: np.ndarray
    in_edge_to_bit: np.ndarray
    out_edge_to_bit: np.ndarray
    edge_in_to_out: np.ndarray
    edge_out_to_in: np.ndarray
    n_erased_vars: int = 0
    n_erased_checks: int = 0

    @property
    def n_edges(self) -> int:
        return int(self.in_edge_to_bit.shape[0])

    @property
    def n_inputs(self) -> int:  # reference naming (h/ldpc_code.h:41)
        return self.n_vars

    @property
    def n_outputs(self) -> int:  # reference naming (h/ldpc_code.h:42)
        return self.n_checks

    @property
    def n_effective_inputs(self) -> int:  # ldpc_code.cpp:234-237
        return self.n_vars - self.n_erased_vars

    @property
    def n_effective_outputs(self) -> int:  # ldpc_code.cpp:239-242
        return self.n_checks - self.n_erased_checks

    @cached_property
    def var_degrees(self) -> np.ndarray:
        return np.diff(self.in_bit_to_edge).astype(np.int32)

    @cached_property
    def check_degrees(self) -> np.ndarray:
        return np.diff(self.out_bit_to_edge).astype(np.int32)

    @property
    def max_degree_in(self) -> int:
        return int(self.var_degrees.max(initial=0))

    @property
    def max_degree_out(self) -> int:
        return int(self.check_degrees.max(initial=0))

    # ------------------------------------------------------------------
    @staticmethod
    def from_alist_data(data: AlistData) -> "LDPCCode":
        """Build the index tables from raw alist contents.

        Vectorized equivalent of ldpc_code.cpp:89-151: the in-edge order is by
        (variable, appearance order in file), which is exactly the stable
        argsort of the check-major flat column array.
        """
        n_edges = int(data.check_adjacency.shape[0])
        out_bit_to_edge = np.zeros(data.n_checks + 1, dtype=np.int32)
        np.cumsum(data.check_degrees, out=out_bit_to_edge[1:])
        in_bit_to_edge = np.zeros(data.n_vars + 1, dtype=np.int32)
        np.cumsum(data.var_degrees, out=in_bit_to_edge[1:])

        out_edge_to_bit = np.repeat(
            np.arange(data.n_checks, dtype=np.int32), data.check_degrees
        )
        # stable sort by variable: position i in sorted order == in-edge i
        edge_in_to_out = np.argsort(
            data.check_adjacency, kind="stable"
        ).astype(np.int32)
        edge_out_to_in = np.empty(n_edges, dtype=np.int32)
        edge_out_to_in[edge_in_to_out] = np.arange(n_edges, dtype=np.int32)
        in_edge_to_bit = data.check_adjacency[edge_in_to_out].astype(np.int32)

        return LDPCCode(
            n_vars=data.n_vars,
            n_checks=data.n_checks,
            in_bit_to_edge=in_bit_to_edge,
            out_bit_to_edge=out_bit_to_edge,
            in_edge_to_bit=in_edge_to_bit,
            out_edge_to_bit=out_edge_to_bit,
            edge_in_to_out=edge_in_to_out,
            edge_out_to_in=edge_out_to_in,
            n_erased_vars=data.n_erased_vars,
            n_erased_checks=data.n_erased_checks,
        )

    @staticmethod
    def from_alist(text_or_path: str) -> "LDPCCode":
        return LDPCCode.from_alist_data(parse_alist(text_or_path))

    def to_alist_data(self) -> AlistData:
        return AlistData(
            n_checks=self.n_checks,
            n_vars=self.n_vars,
            check_degrees=self.check_degrees,
            var_degrees=self.var_degrees,
            check_adjacency=self.in_edge_to_bit[self.edge_out_to_in],
            n_erased_vars=self.n_erased_vars,
            n_erased_checks=self.n_erased_checks,
        )

    def to_alist(self, path: str | None = None) -> str:
        return write_alist(self.to_alist_data(), path)

    # check-major variable index of each out-edge (used by syndrome/parity)
    @cached_property
    def out_edge_to_in_bit(self) -> np.ndarray:
        return self.in_edge_to_bit[self.edge_out_to_in]


def rate(code: LDPCCode) -> float:
    """Code rate, accounting for erased (punctured) variables.

    Matches ldpc_code.cpp:244-254: with i inputs of which e erased and o
    parity bits, rate = (i - o) / (i - e).
    """
    return float(code.n_vars - code.n_checks) / float(
        code.n_vars - code.n_erased_vars
    )


def compute_syndrome(code: LDPCCode, bits: np.ndarray) -> np.ndarray:
    """XOR syndrome of ``bits`` for every frame (numpy reference impl).

    ``bits``: bool/int array of shape [n_vars] or [n_vars, B].
    Returns int8 syndrome of shape [n_checks] or [n_checks, B].

    Equivalent to ldpc_code.cpp:256-286 but via a vectorized segment-XOR
    (sum mod 2 of edge-gathered bits per check).
    """
    squeeze = bits.ndim == 1
    if squeeze:
        bits = bits[:, None]
    if bits.shape[0] != code.n_vars:
        raise ValueError("bits has wrong leading dimension")
    n = bits.shape[1]
    starts = code.out_bit_to_edge[:-1].astype(np.int64)
    empty = code.check_degrees == 0
    syn = np.empty((code.n_checks, n), dtype=np.int8)
    # chunk the frame axis so the [n_edges, chunk] gather stays small
    chunk = max(1, min(n, (1 << 28) // max(code.n_edges, 1)))
    for lo in range(0, n, chunk):
        g = bits[code.out_edge_to_in_bit, lo : lo + chunk].astype(np.uint8)
        # uint8 wraparound preserves parity; degrees < 256 anyway
        sums = np.add.reduceat(g, starts, axis=0)
        syn[:, lo : lo + chunk] = (sums & 1).astype(np.int8)
    # reduceat quirk: empty segments copy the next element; mask them to 0.
    if empty.any():
        syn[empty] = 0
    return syn[:, 0] if squeeze else syn
