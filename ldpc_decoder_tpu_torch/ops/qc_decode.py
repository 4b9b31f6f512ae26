"""QC decode tables: the block orders of a lifted code, as torch tensors.

Port of ``BlockGroup`` and ``QCDecodeTables.from_structure`` of
``ldpc_decoder_tpu/ops/qc_decode.py``. Messages live in ``[n_blocks, Z, B]``
arrays (Z = circulant size, B frames on the last axis); check-order blocks
are grouped by base-row degree and variable-order blocks by base-column
degree, so each degree group is a contiguous block range. Check-order
block t (row r, col c, shift s) holds at row z the edge
(check (r, z) <-> variable (c, (z + s) mod Z)).

The XLA oracle passes of the JAX module are not ported: the port's plain
passes live beside its kernels in :mod:`ops.qc_grouped`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ldpc_decoder_tpu_torch.codes.qc import QCStructure


@dataclasses.dataclass(frozen=True)
class BlockGroup:
    degree: int
    count: int  # number of base nodes (rows or cols) of this degree
    block_start: int  # first block index in the sorted block order


@dataclasses.dataclass(frozen=True)
class QCDecodeTables:
    """Constants of one QC code, on ``device``."""

    n_vars: int
    n_checks: int
    n_edges: int
    Z: int
    n_blocks: int  # base edges
    row_groups: tuple[BlockGroup, ...]  # over check-order blocks
    col_groups: tuple[BlockGroup, ...]  # over variable-order blocks

    cn_shift: torch.Tensor  # [n_blocks] int32 shift of check-order block t
    vn_of_cn: torch.Tensor  # [n_blocks] int32 vn-block index of cn block t
    cn_of_vn: torch.Tensor  # [n_blocks] int32 inverse
    vn_shift: torch.Tensor  # [n_blocks] int32 shift of vn-order block u
    cn_col_of_block: torch.Tensor  # [n_blocks] int32 sorted col of block t

    # natural <-> sorted node orders (pool permutes, packing, erasures)
    vn_pos: torch.Tensor  # [n_vars] int64
    vn_order: torch.Tensor  # [n_vars] int64
    cn_order: torch.Tensor  # [n_checks] int64
    erased_mask_sorted: torch.Tensor  # [n_vars, 1] bool

    @staticmethod
    def from_structure(s: QCStructure, n_erased_vars: int,
                       device: torch.device | str) -> "QCDecodeTables":
        Z = s.Z
        row_deg = s.row_degrees()
        col_deg = s.col_degrees()
        # sorted node orders (by degree, stable)
        row_order = np.argsort(row_deg, kind="stable")
        col_order = np.argsort(col_deg, kind="stable")
        row_pos = np.empty_like(row_order)
        row_pos[row_order] = np.arange(len(row_order))
        col_pos = np.empty_like(col_order)
        col_pos[col_order] = np.arange(len(col_order))

        # check-order blocks: sort base edges by (row_pos, col); vn-order
        # blocks by (col_pos, row)
        cn_key = np.lexsort((s.edge_col, row_pos[s.edge_row]))
        vn_key = np.lexsort((s.edge_row, col_pos[s.edge_col]))
        nb = s.n_base_edges
        vn_rank = np.empty(nb, dtype=np.int64)
        vn_rank[vn_key] = np.arange(nb)
        vn_of_cn = vn_rank[cn_key].astype(np.int32)
        cn_of_vn = np.empty(nb, dtype=np.int32)
        cn_of_vn[vn_of_cn] = np.arange(nb, dtype=np.int32)
        cn_shift = s.edge_shift[cn_key].astype(np.int32)
        vn_shift = cn_shift[cn_of_vn]
        cn_col_of_block = col_pos[s.edge_col[cn_key]].astype(np.int32)

        def groups(sorted_deg):
            degs, starts, counts = np.unique(
                sorted_deg, return_index=True, return_counts=True
            )
            out, blk = [], 0
            for d, c in zip(degs.tolist(), counts.tolist()):
                out.append(BlockGroup(degree=int(d), count=int(c),
                                      block_start=blk))
                blk += int(d) * int(c)
            return tuple(out)

        # block-expanded orders: sorted var row i*Z+z -> natural
        # col_order[i]*Z+z
        z = np.arange(Z, dtype=np.int64)
        vn_order2 = (
            col_order.astype(np.int64)[:, None] * Z + z[None, :]
        ).reshape(-1)
        cn_order2 = (
            row_order.astype(np.int64)[:, None] * Z + z[None, :]
        ).reshape(-1)
        vn_pos2 = np.empty_like(vn_order2)
        vn_pos2[vn_order2] = np.arange(vn_order2.shape[0])

        erased_nat = np.zeros(s.n_base_cols * Z, dtype=bool)
        if n_erased_vars:
            erased_nat[s.n_base_cols * Z - n_erased_vars :] = True

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        return QCDecodeTables(
            n_vars=s.n_base_cols * Z,
            n_checks=s.n_base_rows * Z,
            n_edges=nb * Z,
            Z=Z,
            n_blocks=nb,
            row_groups=groups(row_deg[row_order]),
            col_groups=groups(col_deg[col_order]),
            cn_shift=dev(cn_shift),
            vn_of_cn=dev(vn_of_cn),
            cn_of_vn=dev(cn_of_vn),
            vn_shift=dev(vn_shift),
            cn_col_of_block=dev(cn_col_of_block),
            vn_pos=dev(vn_pos2),
            vn_order=dev(vn_order2),
            cn_order=dev(cn_order2),
            erased_mask_sorted=dev(erased_nat[vn_order2])[:, None],
        )


# ---- min-sum helpers (ldpc_decoder_tpu/ops/qc_decode.py:297-331) -------------

def llr_dtype(msg_dtype: torch.dtype) -> torch.dtype:
    """LLR-state dtype for a message dtype: the message dtype, bfloat16 for
    1-byte messages, int8 and float8_e5m2
    (``ldpc_decoder_tpu/runtime/decoder.py:327-329``)."""
    return torch.bfloat16 if msg_dtype.itemsize == 1 else msg_dtype


def quantize_msgs(x: torch.Tensor, qscale: float) -> torch.Tensor:
    """float LLR messages -> int8 fixed point at ``qscale`` steps per unit:
    round half to even, saturate at ±127 (the hardware min-sum
    quantization; -0.0 becomes 0)."""
    q = torch.round(x.to(torch.float32) * torch.tensor(qscale,
                                                       dtype=torch.float32))
    return q.clamp(-127.0, 127.0).to(torch.int8)


def dequantize_msgs(m: torch.Tensor, qscale: float) -> torch.Tensor:
    """int8 fixed point -> float32 LLRs (exact: qscale is a power of two);
    a zero dequantizes to +0.0."""
    return m.to(torch.float32) * torch.tensor(1.0 / qscale,
                                              dtype=torch.float32)


def msgs_to_f32(x: torch.Tensor, qscale: float) -> torch.Tensor:
    """Stored messages -> float32 (int8: dequantized; float dtypes,
    float8_e5m2 included, exactly)."""
    if x.dtype == torch.int8:
        return dequantize_msgs(x, qscale)
    return x.to(torch.float32)


def store_msgs(out: torch.Tensor, vals: torch.Tensor, qscale: float) -> None:
    """Write float32 messages into ``out`` in its dtype (int8: quantized,
    else rounded to nearest even; float8_e5m2 overflows to ±inf, as torch
    and XLA convert)."""
    if out.dtype == torch.int8:
        out.copy_(quantize_msgs(vals, qscale))
    else:
        out.copy_(vals)


def signed_f32(mag: torch.Tensor, sign: torch.Tensor) -> torch.Tensor:
    """float32 magnitude with the sign bit ``sign`` (int32, 0 or the sign
    bit) OR-ed in."""
    return (mag.view(torch.int32) | sign).view(torch.float32)


def minsum_magnitudes(a, alpha: float, beta: float,
                      sole_zero: bool = True) -> list[torch.Tensor]:
    """The min-sum check rule on the magnitudes ``a`` (d float32 tensors,
    one per slot): |out_k| = max(α·other_k − β, 0), other_k the smallest
    |m_j| with j ≠ k. A two-minimum scan: ties keep the first minimum;
    a sole edge has m2 = 0 when ``sole_zero`` (the grouped and general
    kernels), +inf otherwise (the regular kernel). α·other − β is rounded
    twice, as the CUDA kernels compute it."""
    m1 = a[0]
    m2 = torch.full_like(m1, float("inf"))
    pos = torch.zeros(m1.shape, dtype=torch.int8, device=m1.device)
    for k in range(1, len(a)):
        new = a[k] < m1
        m2 = torch.where(new, m1, torch.minimum(m2, a[k]))
        m1 = torch.where(new, a[k], m1)
        pos = torch.where(new, k, pos).to(torch.int8)
    if sole_zero and len(a) == 1:
        m2 = torch.zeros_like(m1)  # sole edge: empty leave-one-out
    al = torch.tensor(alpha, dtype=torch.float32)
    be = torch.tensor(beta, dtype=torch.float32)
    return [torch.clamp_min(torch.where(pos == k, m2, m1) * al - be, 0.0)
            for k in range(len(a))]


def resolve_minsum_alpha(alpha, degree: int) -> float:
    """Normalization α of normalized min-sum for check degree ``degree``:
    ``alpha`` is a scalar (uniform) or a tuple of (degree, α) pairs, where
    a (0, α) pair is the fallback for degrees not listed."""
    if isinstance(alpha, (int, float)):
        return float(alpha)
    table = dict(alpha)
    if degree in table:
        return float(table[degree])
    if 0 in table:
        return float(table[0])
    raise ValueError(
        f"minsum alpha table {alpha!r} has no entry for check degree "
        f"{degree} and no (0, default) fallback")
