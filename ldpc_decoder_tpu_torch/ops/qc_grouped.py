"""Grouped QC-LDPC passes for irregular bases: tables, plain passes, kernels.

Port of ``ldpc_decoder_tpu/ops/qc_pallas_grouped.py``. Check and variable
nodes are grouped by degree (the sorted orders of
:class:`~ldpc_decoder_tpu_torch.ops.qc_decode.QCDecodeTables` make each
degree group a contiguous range); each group gets one launch with its exact
degree.

Layout: circulant blocks live in flat ``[nb, Z, B]`` arrays, frames on the
last axis — ``msgs_v`` in variable order (column, slot), ``r_c`` in check
order (row, slot). Unlike the JAX package, group starts are not padded to
multiples of the degree (that padding only served Pallas BlockSpecs). Each
slot of a group reads one rotated source block through its per-slot
(source block, shift) table: out[z] = src[(z + s) mod Z]. A CN slot reads
``msgs_v`` with the block's shift s, a VN slot reads ``r_c`` with
(-s) mod Z, a parity slot reads the hard bits of its column with s.

Every pass writes its output in place, group by group: ``cn_pass_grouped``
rewrites all of ``r_c`` and ``vn_pass_grouped`` its groups of ``msgs_v``, so
an iteration allocates no edge-sized buffer.

Two check rules, as in the JAX kernels: sum-product (φ, float32, bfloat16
or float8_e5m2 messages) and normalized/offset min-sum (float32, bfloat16,
float8_e5m2 or int8 fixed-point messages; ``qc_pallas_grouped.py:385-400``,
``:443-455``): |out_k| = max(α_d·(min over j ≠ k of |m_j|) − β, 0) with
ties to the first minimum and m2 = 0 for a sole edge, and the variable
messages clip(total − w_k, ±clamp), the llr itself for d = 1. int8
messages are dequantized on read and quantized on write; float8_e5m2 ones
are converted exactly on read and rounded to nearest even on write. Both
1-byte dtypes keep a bfloat16 llr. Unlike the regular family, this one
clamps φ's input at 80 for every dtype, as its JAX kernels do
(``qc_pallas_grouped.py:410-411``, ``:457-459``): in float8_e5m2 a small φ
underflows to a subnormal or to ±0, and the stored −0 keeps its sign bit,
which the check pass's sign algebra reads.

Each pass has a plain PyTorch version (``*_plain``: a per-group loop of
gathers and elementwise ops, same summation order) and a kernel
(csrc/qc_grouped.cu, min-sum csrc/qc_minsum.cu, via :mod:`._kernels`). The
pass functions dispatch on the tensors' device: CPU tensors take the plain
version (the CPU tests' path); CUDA tensors launch the kernel or raise —
there is no fallback.
"""

from __future__ import annotations

import dataclasses

import torch

from ldpc_decoder_tpu_torch.ops import _kernels
from ldpc_decoder_tpu_torch.ops._dispatch import backend, check
from ldpc_decoder_tpu_torch.ops.phi import PRE_THRESHOLD, phi, phi_abs
from ldpc_decoder_tpu_torch.ops.qc_decode import (
    QCDecodeTables,
    llr_dtype,
    minsum_magnitudes,
    msgs_to_f32,
    quantize_msgs,
    resolve_minsum_alpha,
    signed_f32,
    store_msgs,
)

_MSG_DTYPES = (torch.float32, torch.bfloat16, torch.float8_e5m2)
_MS_DTYPES = _MSG_DTYPES + (torch.int8,)
_SIGN = -(1 << 31)  # the float32 sign bit as an int32


@dataclasses.dataclass(frozen=True)
class Group:
    node_start: int  # first sorted row/col of this degree group
    count: int       # number of nodes
    degree: int
    block_start: int  # first flat block index


@dataclasses.dataclass(frozen=True)
class GroupedQCTables:
    """Group metadata and per-slot (source block, shift) tables.

    All tensors sit on one device; the slot tables are int32 [nb]."""

    n_vars: int
    n_checks: int
    n_edges: int
    Z: int
    nb: int  # circulant blocks (base edges)
    C: int   # base columns
    R: int   # base rows
    row_groups: tuple[Group, ...]
    col_groups: tuple[Group, ...]

    cn_src: torch.Tensor    # vn block read by check-order block e
    cn_shift: torch.Tensor  # its shift s
    vn_src: torch.Tensor    # check-order block read by vn block u
    vn_shift: torch.Tensor  # (-s) mod Z
    par_src: torch.Tensor   # sorted column whose bits check block e reads
    par_shift: torch.Tensor  # s

    vn_pos: torch.Tensor
    vn_order: torch.Tensor
    cn_order: torch.Tensor
    erased_mask_sorted: torch.Tensor  # [n_vars, 1] bool

    @property
    def device(self) -> torch.device:
        return self.cn_src.device

    @property
    def max_degree(self) -> int:
        return max(g.degree for g in self.row_groups + self.col_groups)

    @staticmethod
    def from_qc_tables(t: QCDecodeTables) -> "GroupedQCTables":
        def node_groups(block_groups):
            out, node = [], 0
            for g in block_groups:
                out.append(Group(node_start=node, count=g.count,
                                 degree=g.degree, block_start=g.block_start))
                node += g.count
            return tuple(out)

        i32 = torch.int32
        cn_shift = t.cn_shift.to(i32)
        return GroupedQCTables(
            n_vars=t.n_vars, n_checks=t.n_checks, n_edges=t.n_edges,
            Z=t.Z, nb=t.n_blocks, C=t.n_vars // t.Z, R=t.n_checks // t.Z,
            row_groups=node_groups(t.row_groups),
            col_groups=node_groups(t.col_groups),
            cn_src=t.vn_of_cn.to(i32).contiguous(),
            cn_shift=cn_shift.contiguous(),
            vn_src=t.cn_of_vn.to(i32).contiguous(),
            vn_shift=((-cn_shift[t.cn_of_vn.long()]) % t.Z).to(i32)
            .contiguous(),
            par_src=t.cn_col_of_block.to(i32).contiguous(),
            par_shift=cn_shift.contiguous(),
            vn_pos=t.vn_pos, vn_order=t.vn_order, cn_order=t.cn_order,
            erased_mask_sorted=t.erased_mask_sorted,
        )


# ---- argument checks and dispatch ----------------------------------------

def _backend(tables: GroupedQCTables, *tensors: torch.Tensor,
             lib: str = "qc_grouped") -> str:
    return backend(tables.device, tables.max_degree,
                   _kernels.MAX_DEGREES[lib], *tensors)


def _check_msgs(tables, a, name_a, b, name_b, dtypes=_MSG_DTYPES):
    B = a.shape[-1]
    check(a, name_a, (tables.nb, tables.Z, B), dtypes)
    check(b, name_b, (tables.nb, tables.Z, B), (a.dtype,))
    return B


def _check_vn_args(tables, r_c, llr, msgs_v, bits, fresh, dtypes):
    """B and the tensors to dispatch on, for a variable pass."""
    B = _check_msgs(tables, r_c, "r_c", msgs_v, "msgs_v", dtypes)
    check(llr, "llr", (tables.C, tables.Z, B), (llr_dtype(r_c.dtype),))
    tensors = [r_c, llr, msgs_v]
    if bits is not None:
        check(bits, "bits", (tables.C, tables.Z, B), (torch.int8,))
        tensors.append(bits)
    if fresh is not None:
        check(fresh, "fresh", (B,), (torch.bool,))
        tensors.append(fresh)
    return B, tensors


def _rotated(src: torch.Tensor, blocks: torch.Tensor, shifts: torch.Tensor,
             Z: int) -> torch.Tensor:
    """[n, Z, B] gather: out[j, z] = src[blocks[j], (z + shifts[j]) mod Z]."""
    rows = (torch.arange(Z, device=src.device)[None, :]
            + shifts.long()[:, None]) % Z
    return src[blocks.long()[:, None], rows]


# ---- check-node pass -------------------------------------------------------

def cn_pass_plain(msgs_v, syn, r_c, tables: GroupedQCTables,
                  pre: float = PRE_THRESHOLD) -> torch.Tensor:
    """Plain PyTorch check-node pass (the counterpart of the CUDA kernel):
    r_c[slot k] = φ_abs(Σ_j |m_j| − |m_k|) with the sign from the sign-bit
    algebra X = (syn ⊕ d)<<31 ⊕ (⊕_j sb_j), sign_k = sb_k ⊕ X."""
    Z = tables.Z
    for g in tables.row_groups:
        d, n = g.degree, g.count
        sl = slice(g.block_start, g.block_start + n * d)
        m = _rotated(msgs_v, tables.cn_src[sl], tables.cn_shift[sl], Z)
        m = m.to(torch.float32).view(n, d, Z, -1)
        sb = m.view(torch.int32) & _SIGN
        a = m.abs()
        X = syn[g.node_start : g.node_start + n].to(torch.int32) * _SIGN
        if d % 2:
            X = X ^ _SIGN
        for k in range(d):
            X = X ^ sb[:, k]
        ext = a[:, 0]
        for k in range(1, d):  # left to right, as the kernel sums
            ext = ext + a[:, k]
        out = r_c[sl].view(n, d, Z, -1)
        for k in range(d):
            res = phi_abs(ext - a[:, k], pre)
            out[:, k] = (res.view(torch.int32) | (sb[:, k] ^ X)).view(
                torch.float32)
    return r_c


def cn_pass_grouped(msgs_v, syn, r_c, tables: GroupedQCTables,
                    pre: float = PRE_THRESHOLD) -> torch.Tensor:
    """msgs_v [nb, Z, B] (vn order), syn [R, Z, B] int8 -> r_c [nb, Z, B]
    (check order), every block rewritten in place; returns r_c."""
    B = _check_msgs(tables, msgs_v, "msgs_v", r_c, "r_c")
    check(syn, "syn", (tables.R, tables.Z, B), (torch.int8,))
    if _backend(tables, msgs_v, syn, r_c) == "cpu":
        return cn_pass_plain(msgs_v, syn, r_c, tables, pre)
    with torch.cuda.device(msgs_v.device):
        for g in tables.row_groups:
            _kernels.cn_group(msgs_v, syn, r_c, tables.cn_src,
                              tables.cn_shift, g, tables.Z, B, pre)
    return r_c


# ---- variable-node pass ------------------------------------------------------

def _vn_groups(tables, emit: bool, include_d1: bool):
    # A degree-1 variable's outgoing message is φ(total − r) = φ(llr):
    # constant while its llr is. Its blocks keep the init value, so the
    # group is skipped on non-emit iterations; emit iterations and the
    # first iteration after a refill (include_d1) still run it.
    return [g for g in tables.col_groups
            if g.degree > 1 or emit or include_d1]


def vn_pass_plain(r_c, llr, msgs_v, tables: GroupedQCTables,
                  pre: float = PRE_THRESHOLD, bits=None, fresh=None,
                  include_d1: bool = False) -> torch.Tensor:
    """Plain PyTorch variable-node pass (the counterpart of the CUDA
    kernel): total = llr + Σ_k w_k in slot order; slot k gets
    φ(total − w_k), φ(llr) for d = 1 or a fresh lane; bits = ¬signbit."""
    Z = tables.Z
    for g in _vn_groups(tables, bits is not None, include_d1):
        d, n = g.degree, g.count
        sl = slice(g.block_start, g.block_start + n * d)
        w = _rotated(r_c, tables.vn_src[sl], tables.vn_shift[sl], Z)
        w = w.to(torch.float32).view(n, d, Z, -1)
        cols = slice(g.node_start, g.node_start + n)
        lv = llr[cols].to(torch.float32)
        total = lv
        for k in range(d):
            total = total + w[:, k]
        if bits is not None:
            tb = total if fresh is None else torch.where(fresh, lv, total)
            bits[cols] = (~torch.signbit(tb)).to(torch.int8)
        out = msgs_v[sl].view(n, d, Z, -1)
        for k in range(d):
            if d == 1:
                p = lv  # sole edge: the leave-one-out sum is llr exactly
            else:
                p = total - w[:, k]
                if fresh is not None:
                    p = torch.where(fresh, lv, p)
            out[:, k] = phi(p, pre)
    return msgs_v


def vn_pass_grouped(r_c, llr, msgs_v, tables: GroupedQCTables,
                    pre: float = PRE_THRESHOLD, bits=None, fresh=None,
                    include_d1: bool = False) -> torch.Tensor:
    """r_c [nb, Z, B] (check order), llr [C, Z, B] (the message dtype;
    bfloat16 for float8_e5m2) -> msgs_v [nb, Z, B] in place; returns
    msgs_v.

    ``bits`` ([C, Z, B] int8 or None): emit hard decisions into it.
    ``fresh`` ([B] bool or None): lane-reset refill — flagged lanes carry a
    retired frame's messages and emit the init values φ(llr) instead.
    ``include_d1``: run the degree-1 groups on a non-emit iteration (the
    first iteration after a refill, when their φ(llr) changed)."""
    B, tensors = _check_vn_args(tables, r_c, llr, msgs_v, bits, fresh,
                                _MSG_DTYPES)
    if _backend(tables, *tensors) == "cpu":
        return vn_pass_plain(r_c, llr, msgs_v, tables, pre, bits, fresh,
                             include_d1)
    with torch.cuda.device(r_c.device):
        for g in _vn_groups(tables, bits is not None, include_d1):
            _kernels.vn_group(r_c, llr, msgs_v, bits, fresh, tables.vn_src,
                              tables.vn_shift, g, tables.Z, B, pre)
    return msgs_v


# ---- min-sum check and variable passes ----------------------------------------

def cn_pass_minsum_plain(msgs_v, syn, r_c, tables: GroupedQCTables,
                         alpha=1.0, beta: float = 0.0,
                         qscale: float = 4.0) -> torch.Tensor:
    """Plain PyTorch min-sum check pass (the counterpart of the CUDA
    kernel): per group the two-minimum scan of |m| (ties to the first
    minimum; m2 = 0 for a sole edge), |out_k| = max(α_d·other − β, 0)
    with the sign-bit algebra; int8 quantized on write."""
    Z = tables.Z
    for g in tables.row_groups:
        d, n = g.degree, g.count
        sl = slice(g.block_start, g.block_start + n * d)
        m = msgs_to_f32(_rotated(msgs_v, tables.cn_src[sl],
                                 tables.cn_shift[sl], Z), qscale)
        m = m.view(n, d, Z, -1)
        sb = m.view(torch.int32) & _SIGN
        a = m.abs()
        X = syn[g.node_start : g.node_start + n].to(torch.int32) * _SIGN
        if d % 2:
            X = X ^ _SIGN
        for k in range(d):
            X = X ^ sb[:, k]
        res = minsum_magnitudes([a[:, k] for k in range(d)],
                                resolve_minsum_alpha(alpha, d), beta)
        out = r_c[sl].view(n, d, Z, -1)
        for k in range(d):
            store_msgs(out[:, k], signed_f32(res[k], sb[:, k] ^ X), qscale)
    return r_c


def cn_pass_grouped_minsum(msgs_v, syn, r_c, tables: GroupedQCTables,
                           alpha=1.0, beta: float = 0.0,
                           qscale: float = 4.0) -> torch.Tensor:
    """Min-sum check pass: msgs_v [nb, Z, B] (f32, bf16, fp8 or int8) -> r_c
    in place; ``alpha`` a float or (degree, α) pairs, resolved per group;
    ``qscale`` is read for int8 messages only. Returns r_c."""
    B = _check_msgs(tables, msgs_v, "msgs_v", r_c, "r_c", _MS_DTYPES)
    check(syn, "syn", (tables.R, tables.Z, B), (torch.int8,))
    if _backend(tables, msgs_v, syn, r_c, lib="qc_minsum") == "cpu":
        return cn_pass_minsum_plain(msgs_v, syn, r_c, tables, alpha, beta,
                                    qscale)
    with torch.cuda.device(msgs_v.device):
        for g in tables.row_groups:
            _kernels.cn_group_minsum(
                msgs_v, syn, r_c, tables.cn_src, tables.cn_shift, g,
                tables.Z, B, resolve_minsum_alpha(alpha, g.degree), beta,
                qscale)
    return r_c


def vn_pass_minsum_plain(r_c, llr, msgs_v, tables: GroupedQCTables,
                         clamp: float = 64.0, qscale: float = 4.0,
                         bits=None, fresh=None,
                         include_d1: bool = False) -> torch.Tensor:
    """Plain PyTorch min-sum variable pass (the counterpart of the CUDA
    kernel): total = llr + Σ_k w_k in slot order; slot k gets
    clip(total − w_k, ±clamp), clip(llr) for d = 1 or a fresh lane; int8
    quantized on write; bits = ¬signbit."""
    Z = tables.Z
    for g in _vn_groups(tables, bits is not None, include_d1):
        d, n = g.degree, g.count
        sl = slice(g.block_start, g.block_start + n * d)
        w = msgs_to_f32(_rotated(r_c, tables.vn_src[sl],
                                 tables.vn_shift[sl], Z), qscale)
        w = w.view(n, d, Z, -1)
        cols = slice(g.node_start, g.node_start + n)
        lv = llr[cols].to(torch.float32)
        total = lv
        for k in range(d):
            total = total + w[:, k]
        if bits is not None:
            tb = total if fresh is None else torch.where(fresh, lv, total)
            bits[cols] = (~torch.signbit(tb)).to(torch.int8)
        out = msgs_v[sl].view(n, d, Z, -1)
        for k in range(d):
            if d == 1:
                p = lv  # sole edge: the leave-one-out sum is llr exactly
            else:
                p = total - w[:, k]
                if fresh is not None:
                    p = torch.where(fresh, lv, p)
            store_msgs(out[:, k], p.clamp(-clamp, clamp), qscale)
    return msgs_v


def vn_pass_grouped_minsum(r_c, llr, msgs_v, tables: GroupedQCTables,
                           clamp: float = 64.0, qscale: float = 4.0,
                           bits=None, fresh=None,
                           include_d1: bool = False) -> torch.Tensor:
    """Min-sum variable pass: r_c [nb, Z, B] (f32, bf16, fp8 or int8), llr
    [C, Z, B] (the message dtype; bfloat16 for int8 and fp8) -> msgs_v in
    place;
    ``bits``, ``fresh`` and ``include_d1`` as in :func:`vn_pass_grouped`.
    Returns msgs_v."""
    B, tensors = _check_vn_args(tables, r_c, llr, msgs_v, bits, fresh,
                                _MS_DTYPES)
    if _backend(tables, *tensors, lib="qc_minsum") == "cpu":
        return vn_pass_minsum_plain(r_c, llr, msgs_v, tables, clamp, qscale,
                                    bits, fresh, include_d1)
    with torch.cuda.device(r_c.device):
        for g in _vn_groups(tables, bits is not None, include_d1):
            _kernels.vn_group_minsum(r_c, llr, msgs_v, bits, fresh,
                                     tables.vn_src, tables.vn_shift, g,
                                     tables.Z, B, clamp, qscale)
    return msgs_v


# ---- parity pass --------------------------------------------------------------

def parity_pass_plain(bits, syn, tables: GroupedQCTables) -> torch.Tensor:
    """Plain PyTorch parity check (the counterpart of the CUDA kernel):
    [B] bool, True where any check of the lane is violated."""
    Z, B = tables.Z, bits.shape[-1]
    viol = torch.zeros(B, dtype=torch.bool, device=bits.device)
    for g in tables.row_groups:
        d, n = g.degree, g.count
        sl = slice(g.block_start, g.block_start + n * d)
        x = _rotated(bits, tables.par_src[sl], tables.par_shift[sl], Z)
        x = x.to(torch.int32).view(n, d, Z, B)
        acc = syn[g.node_start : g.node_start + n].to(torch.int32)
        for k in range(d):
            acc = acc + x[:, k]
        viol |= (acc & 1).amax(dim=(0, 1)) > 0
    return viol


def parity_pass_grouped(bits, syn, tables: GroupedQCTables) -> torch.Tensor:
    """bits [C, Z, B] int8 (sorted columns), syn [R, Z, B] int8 -> [B]
    bool, True where any check of the lane is violated."""
    B = bits.shape[-1]
    check(bits, "bits", (tables.C, tables.Z, B), (torch.int8,))
    check(syn, "syn", (tables.R, tables.Z, B), (torch.int8,))
    if _backend(tables, bits, syn) == "cpu":
        return parity_pass_plain(bits, syn, tables)
    flags = torch.zeros(B, dtype=torch.int32, device=bits.device)
    with torch.cuda.device(bits.device):
        for g in tables.row_groups:
            _kernels.parity_group(bits, syn, flags, tables.par_src,
                                  tables.par_shift, g, tables.Z, B)
    return flags != 0


# ---- message init and iteration runners -------------------------------------

def init_messages_qc_grouped(llr, tables: GroupedQCTables,
                             dtype=torch.float32,
                             pre: float = PRE_THRESHOLD,
                             alg: str = "sum-product", clamp: float = 64.0,
                             qscale: float = 4.0):
    """(msgs_v, r_c) for sorted llr [C, Z, B]: every slot of a variable
    gets its init message in ``dtype`` (``qc_pallas_grouped.py:682-730``):
    φ(llr) for sum-product; for min-sum quantize(clip(llr)) in int8, else
    the llr itself, clipped in degree-1 groups (the degree-1 launch skip
    keeps those as the messages the variable kernel would write). r_c is
    left uninitialised: every check pass rewrites all of it before any
    read."""
    Z, B = tables.Z, llr.shape[-1]
    if alg == "min-sum":
        lv = llr.to(torch.float32)
        clipped = lv.clamp(-clamp, clamp)
        if dtype == torch.int8:
            p = p1 = quantize_msgs(clipped, qscale)
        else:
            p, p1 = lv.to(dtype), clipped.to(dtype)
    else:
        p = p1 = phi(llr, pre).to(dtype)
    msgs_v = torch.empty((tables.nb, Z, B), dtype=dtype, device=llr.device)
    for g in tables.col_groups:
        sl = slice(g.block_start, g.block_start + g.count * g.degree)
        cols = (p1 if g.degree == 1 else p)[g.node_start
                                            : g.node_start + g.count]
        msgs_v[sl].view(g.count, g.degree, Z, B).copy_(
            cols[:, None].expand(g.count, g.degree, Z, B))
    return msgs_v, torch.empty_like(msgs_v)


def _iteration(msgs_v, r_c, llr, syn, tables, pre, alg, beta, clamp, alpha,
               qscale, bits=None, fresh=None, include_d1=False):
    if alg == "min-sum":
        cn_pass_grouped_minsum(msgs_v, syn, r_c, tables, alpha, beta, qscale)
        vn_pass_grouped_minsum(r_c, llr, msgs_v, tables, clamp, qscale,
                               bits, fresh, include_d1)
    else:
        cn_pass_grouped(msgs_v, syn, r_c, tables, pre)
        vn_pass_grouped(r_c, llr, msgs_v, tables, pre, bits, fresh,
                        include_d1)


def run_iterations_qc_grouped(msgs, llr, syn, tables: GroupedQCTables,
                              k: int, pre: float = PRE_THRESHOLD,
                              fresh=None, alg: str = "sum-product",
                              beta: float = 0.0, clamp: float = 64.0,
                              alpha=1.0, qscale: float = 4.0):
    """k flood iterations, the last one emitting hard decisions, then the
    parity check. ``msgs`` is the (msgs_v, r_c) pair, updated in place.
    ``alg`` and the min-sum parameters select the check rule
    (``run_iterations_qc_grouped`` of the JAX package).

    ``fresh`` ([B] bool or None): lanes refilled since the last call; their
    first iteration's VN pass emits init values (lane reset) and refreshes
    the degree-1 groups. Returns (msgs, bits [C, Z, B] int8, violated [B])."""
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    msgs_v, r_c = msgs
    rule = (pre, alg, beta, clamp, alpha, qscale)
    lo = 0
    if fresh is not None and k > 1:
        _iteration(msgs_v, r_c, llr, syn, tables, *rule, fresh=fresh,
                   include_d1=True)
        lo = 1
    for _ in range(lo, k - 1):
        _iteration(msgs_v, r_c, llr, syn, tables, *rule)
    bits = torch.empty((tables.C, tables.Z, llr.shape[-1]), dtype=torch.int8,
                       device=llr.device)
    _iteration(msgs_v, r_c, llr, syn, tables, *rule, bits=bits,
               fresh=fresh if k == 1 else None)
    violated = parity_pass_grouped(bits, syn, tables)
    return (msgs_v, r_c), bits, violated


def burst_iterations_qc_grouped(msgs, llr, syn, tables: GroupedQCTables,
                                b: int, pre: float = PRE_THRESHOLD,
                                alg: str = "sum-product", beta: float = 0.0,
                                clamp: float = 64.0, alpha=1.0,
                                qscale: float = 4.0):
    """``b`` plain iterations with no emit and no parity check — the
    delayed-first-check phase. burst(b) then run_iterations(k) equals
    run_iterations(b + k) bit for bit. Updates ``msgs`` in place."""
    msgs_v, r_c = msgs
    for _ in range(b):
        _iteration(msgs_v, r_c, llr, syn, tables, pre, alg, beta, clamp,
                   alpha, qscale)
    return msgs_v, r_c
