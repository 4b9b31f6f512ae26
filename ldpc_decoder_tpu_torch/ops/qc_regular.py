"""Regular QC-LDPC passes: tables, plain passes, kernels.

Port of ``ldpc_decoder_tpu/ops/qc_pallas.py``, the family for regular base
matrices (one check degree d_c, one variable degree d_v); irregular bases
take :mod:`.qc_grouped`. Both compute the same function: on a regular base
the grouped layout is this one, flattened.

Layout (the JAX package's): frames on the last axis; ``msgs_v
[C, d_v, Z, B]`` in variable order, ``r_c [R, d_c, Z, B]`` in check order,
``llr`` and ``bits`` ``[C, Z, B]``, ``syn [R, Z, B]`` int8. Every pass
writes its output in place, so an iteration allocates no edge-sized
buffer.

Tables: ``cn_read [R, d_c, 3]`` and ``vn_read [C, d_v, 3]`` hold (source
node, source slot, absolute shift) per slot; a rotated read is
out[z] = src[(z + s) mod Z]. CN slot (r, k) reads ``msgs_v[u // d_v,
u % d_v]`` with the block's shift s (u = ``vn_of_cn[r·d_c + k]``); VN slot
(c, i) reads ``r_c[t // d_c, t % d_c]`` with (−s) mod Z (t =
``cn_of_vn[c·d_v + i]``); parity slot (r, k) reads the hard bits of column
``cn_read[r, k, 0]`` with ``cn_read[r, k, 2]``. The JAX tables' tile, seam,
signed fine shifts, pair mode, ``LANE_BLOCK`` and ``LDPC_*`` knobs only
serve Mosaic's windowed reads (``qc_pallas.py:64-79``, ``:272-326``) and
are not carried over: the kernels take any shift.

Two check rules, as in the JAX kernels: sum-product and normalized/offset
min-sum (``qc_pallas.py:446-459``, ``:504-506``), both on float32,
bfloat16 or float8_e5m2 messages (int8 decodes take the grouped family, as
in the JAX decoder). float8_e5m2 messages keep a bfloat16 llr
(``qc_pallas.py:660-662``) and clamp φ's input at 10
(:func:`~ldpc_decoder_tpu_torch.ops.phi.phi_high`), so every φ value stays
a normal e5m2. The min-sum init is the unclipped llr
(``qc_pallas.py:623-624``) while the variable pass writes clip(total − w_k,
±clamp) and fresh lanes clip(llr).

Each pass has a plain PyTorch version (``*_plain``: gathers and
elementwise ops in the kernel's summation order) and a kernel
(csrc/qc_regular.cuh, min-sum csrc/qc_minsum.cu, via :mod:`._kernels`, one
launch per pass). The pass functions dispatch on the tensors' device: CPU
tensors take the plain version; CUDA tensors launch the kernel or raise —
there is no fallback. The sum-product kernels evaluate φ from the card's
MUFU operations (the decoder's); their internal ``_phi="accurate"``
keyword selects the plain version's φ instead, as on the grouped passes.
"""

from __future__ import annotations

import dataclasses

import torch

from ldpc_decoder_tpu_torch.ops import _kernels
from ldpc_decoder_tpu_torch.ops._dispatch import backend, check
from ldpc_decoder_tpu_torch.ops.phi import (
    PRE_THRESHOLD,
    phi,
    phi_abs,
    phi_high,
)
from ldpc_decoder_tpu_torch.ops.qc_decode import (
    QCDecodeTables,
    llr_dtype,
    minsum_magnitudes,
    resolve_minsum_alpha,
    signed_f32,
)

_MSG_DTYPES = (torch.float32, torch.bfloat16, torch.float8_e5m2)
_SIGN = -(1 << 31)  # the float32 sign bit as an int32


@dataclasses.dataclass(frozen=True)
class QCRegularTables:
    """Sizes and per-slot read tables of a regular QC code; the tensors sit
    on one device."""

    n_vars: int
    n_checks: int
    n_edges: int
    Z: int
    C: int    # base columns
    R: int    # base rows
    d_v: int
    d_c: int

    cn_read: torch.Tensor  # [R, d_c, 3] int32 (variable, slot, s)
    vn_read: torch.Tensor  # [C, d_v, 3] int32 (check, slot, (-s) mod Z)

    vn_pos: torch.Tensor
    vn_order: torch.Tensor
    cn_order: torch.Tensor
    erased_mask_sorted: torch.Tensor  # [n_vars, 1] bool

    @property
    def device(self) -> torch.device:
        return self.cn_read.device

    @property
    def max_degree(self) -> int:
        return max(self.d_c, self.d_v)

    @staticmethod
    def from_qc_tables(t: QCDecodeTables) -> "QCRegularTables":
        if len(t.row_groups) != 1 or len(t.col_groups) != 1:
            raise ValueError("the regular kernels need a regular base matrix "
                             "(one check degree and one variable degree)")
        d_c, R = t.row_groups[0].degree, t.row_groups[0].count
        d_v, C = t.col_groups[0].degree, t.col_groups[0].count
        Z = t.Z
        shift = t.cn_shift.long()
        u = t.vn_of_cn.long().view(R, d_c)
        tt = t.cn_of_vn.long().view(C, d_v)
        cn_read = torch.stack([u // d_v, u % d_v, shift.view(R, d_c)], -1)
        vn_read = torch.stack([tt // d_c, tt % d_c, (-shift[tt]) % Z], -1)
        return QCRegularTables(
            n_vars=t.n_vars, n_checks=t.n_checks, n_edges=t.n_edges, Z=Z,
            C=C, R=R, d_v=d_v, d_c=d_c,
            cn_read=cn_read.to(torch.int32).contiguous(),
            vn_read=vn_read.to(torch.int32).contiguous(),
            vn_pos=t.vn_pos, vn_order=t.vn_order, cn_order=t.cn_order,
            erased_mask_sorted=t.erased_mask_sorted,
        )


def _backend(tables: QCRegularTables, *tensors: torch.Tensor,
             lib: str = "qc_regular") -> str:
    return backend(tables.device, tables.max_degree,
                   _kernels.MAX_DEGREES[lib], *tensors)


def _check_cn_args(msgs_v, syn, r_c, t: QCRegularTables) -> None:
    B = msgs_v.shape[-1]
    check(msgs_v, "msgs_v", (t.C, t.d_v, t.Z, B), _MSG_DTYPES)
    check(r_c, "r_c", (t.R, t.d_c, t.Z, B), (msgs_v.dtype,))
    check(syn, "syn", (t.R, t.Z, B), (torch.int8,))


def _check_vn_args(r_c, llr, msgs_v, bits, fresh, t: QCRegularTables):
    """The tensors to dispatch on, for a variable pass."""
    B = r_c.shape[-1]
    check(r_c, "r_c", (t.R, t.d_c, t.Z, B), _MSG_DTYPES)
    check(msgs_v, "msgs_v", (t.C, t.d_v, t.Z, B), (r_c.dtype,))
    check(llr, "llr", (t.C, t.Z, B), (llr_dtype(r_c.dtype),))
    tensors = [r_c, llr, msgs_v]
    if bits is not None:
        check(bits, "bits", (t.C, t.Z, B), (torch.int8,))
        tensors.append(bits)
    if fresh is not None:
        check(fresh, "fresh", (B,), (torch.bool,))
        tensors.append(fresh)
    return tensors


def _rows(read: torch.Tensor, Z: int) -> torch.Tensor:
    """[N, D, Z] source row of each output row: (z + s) mod Z."""
    z = torch.arange(Z, device=read.device)
    return (z[None, None, :] + read[..., 2:3].long()) % Z


def _rotated(src: torch.Tensor, read: torch.Tensor, Z: int) -> torch.Tensor:
    """[N, D, Z, B] gather from messages [N', D', Z, B]:
    out[n, k, z] = src[read[n, k, 0], read[n, k, 1], (z + read[n, k, 2])
    mod Z]."""
    return src[read[..., 0:1].long(), read[..., 1:2].long(), _rows(read, Z)]


# ---- check-node pass -------------------------------------------------------

def cn_pass_plain(msgs_v, syn, r_c, tables: QCRegularTables,
                  pre: float = PRE_THRESHOLD) -> torch.Tensor:
    """Plain PyTorch check-node pass (the counterpart of the CUDA kernel):
    r_c[r, k] = φ_abs(Σ_j |m_j| − |m_k|) with the sign from the sign-bit
    algebra X = (syn ⊕ d_c)<<31 ⊕ (⊕_j sb_j), sign_k = sb_k ⊕ X; φ's input
    clamped at :func:`phi_high` of the message dtype."""
    d, high = tables.d_c, phi_high(r_c.dtype)
    m = _rotated(msgs_v, tables.cn_read, tables.Z).to(torch.float32)
    sb = m.view(torch.int32) & _SIGN
    a = m.abs()
    X = syn.to(torch.int32) * _SIGN
    if d % 2:
        X = X ^ _SIGN
    for k in range(d):
        X = X ^ sb[:, k]
    ext = a[:, 0]
    for k in range(1, d):  # left to right, as the kernel sums
        ext = ext + a[:, k]
    for k in range(d):
        res = phi_abs(ext - a[:, k], pre, high)
        r_c[:, k] = (res.view(torch.int32) | (sb[:, k] ^ X)).view(
            torch.float32)
    return r_c


def cn_pass_regular(msgs_v, syn, r_c, tables: QCRegularTables,
                    pre: float = PRE_THRESHOLD, *,
                    _phi: str = "fast") -> torch.Tensor:
    """msgs_v [C, d_v, Z, B], syn [R, Z, B] int8 -> r_c [R, d_c, Z, B],
    rewritten in place; returns r_c.

    ``_phi`` (internal: the tests and chip_smoke.py) selects the kernel's φ:
    "fast" (MUFU and FMA, what the decoder runs) or "accurate" (the
    accurate tanhf/logf/expf, the plain version's arithmetic). The plain
    version has one φ and ignores it."""
    t = tables
    _kernels.check_phi(_phi)
    _check_cn_args(msgs_v, syn, r_c, t)
    if _backend(t, msgs_v, syn, r_c) == "cpu":
        return cn_pass_plain(msgs_v, syn, r_c, t, pre)
    with torch.cuda.device(msgs_v.device):
        _kernels.cn_regular(msgs_v, syn, r_c, t, pre, _phi)
    return r_c


# ---- variable-node pass ------------------------------------------------------

def vn_pass_plain(r_c, llr, msgs_v, tables: QCRegularTables,
                  pre: float = PRE_THRESHOLD, bits=None,
                  fresh=None) -> torch.Tensor:
    """Plain PyTorch variable-node pass (the counterpart of the CUDA
    kernel): total = llr + Σ_k w_k in slot order; slot k gets
    φ(total − w_k), or φ(llr) on a fresh lane; bits = ¬signbit(total)."""
    high = phi_high(msgs_v.dtype)
    w = _rotated(r_c, tables.vn_read, tables.Z).to(torch.float32)
    lv = llr.to(torch.float32)
    total = lv
    for k in range(tables.d_v):
        total = total + w[:, k]
    if bits is not None:
        tb = total if fresh is None else torch.where(fresh, lv, total)
        bits.copy_(~torch.signbit(tb))
    for k in range(tables.d_v):
        p = total - w[:, k]
        if fresh is not None:
            p = torch.where(fresh, lv, p)
        msgs_v[:, k] = phi(p, pre, high)
    return msgs_v


def vn_pass_regular(r_c, llr, msgs_v, tables: QCRegularTables,
                    pre: float = PRE_THRESHOLD, bits=None, fresh=None, *,
                    _phi: str = "fast") -> torch.Tensor:
    """r_c [R, d_c, Z, B], llr [C, Z, B] (the message dtype; bfloat16 for
    float8_e5m2) -> msgs_v [C, d_v, Z, B] in place; returns msgs_v.

    ``bits`` ([C, Z, B] int8 or None): emit hard decisions into it.
    ``fresh`` ([B] bool or None): lane-reset refill — flagged lanes carry a
    retired frame's messages and emit the init values φ(llr) instead.
    ``_phi`` as in :func:`cn_pass_regular`."""
    t = tables
    _kernels.check_phi(_phi)
    tensors = _check_vn_args(r_c, llr, msgs_v, bits, fresh, t)
    if _backend(t, *tensors) == "cpu":
        return vn_pass_plain(r_c, llr, msgs_v, t, pre, bits, fresh)
    with torch.cuda.device(r_c.device):
        _kernels.vn_regular(r_c, llr, msgs_v, bits, fresh, t, pre, _phi)
    return msgs_v


# ---- min-sum check and variable passes ----------------------------------------

def cn_pass_minsum_plain(msgs_v, syn, r_c, tables: QCRegularTables,
                         alpha=1.0, beta: float = 0.0) -> torch.Tensor:
    """Plain PyTorch min-sum check pass (the counterpart of the CUDA
    kernel): the two-minimum scan of |m| (ties to the first minimum),
    |out_k| = max(α_{d_c}·other − β, 0) with the sign-bit algebra. As in
    the Pallas kernel a sole edge (d_c = 1) keeps m2 = +inf."""
    d = tables.d_c
    m = _rotated(msgs_v, tables.cn_read, tables.Z).to(torch.float32)
    sb = m.view(torch.int32) & _SIGN
    a = m.abs()
    X = syn.to(torch.int32) * _SIGN
    if d % 2:
        X = X ^ _SIGN
    for k in range(d):
        X = X ^ sb[:, k]
    res = minsum_magnitudes([a[:, k] for k in range(d)],
                            resolve_minsum_alpha(alpha, d), beta,
                            sole_zero=False)
    for k in range(d):
        r_c[:, k] = signed_f32(res[k], sb[:, k] ^ X)
    return r_c


def cn_pass_regular_minsum(msgs_v, syn, r_c, tables: QCRegularTables,
                           alpha=1.0, beta: float = 0.0) -> torch.Tensor:
    """Min-sum check pass: msgs_v [C, d_v, Z, B] (f32, bf16 or fp8) -> r_c
    [R, d_c, Z, B] in place; ``alpha`` a float or (degree, α) pairs,
    resolved at d_c. Returns r_c."""
    t = tables
    _check_cn_args(msgs_v, syn, r_c, t)
    if _backend(t, msgs_v, syn, r_c, lib="qc_minsum") == "cpu":
        return cn_pass_minsum_plain(msgs_v, syn, r_c, t, alpha, beta)
    with torch.cuda.device(msgs_v.device):
        _kernels.cn_regular_minsum(msgs_v, syn, r_c, t,
                                   resolve_minsum_alpha(alpha, t.d_c), beta)
    return r_c


def vn_pass_minsum_plain(r_c, llr, msgs_v, tables: QCRegularTables,
                         clamp: float = 64.0, bits=None,
                         fresh=None) -> torch.Tensor:
    """Plain PyTorch min-sum variable pass (the counterpart of the CUDA
    kernel): total = llr + Σ_k w_k in slot order; slot k gets
    clip(total − w_k, ±clamp), or clip(llr) on a fresh lane; bits =
    ¬signbit(total)."""
    w = _rotated(r_c, tables.vn_read, tables.Z).to(torch.float32)
    lv = llr.to(torch.float32)
    total = lv
    for k in range(tables.d_v):
        total = total + w[:, k]
    if bits is not None:
        tb = total if fresh is None else torch.where(fresh, lv, total)
        bits.copy_(~torch.signbit(tb))
    for k in range(tables.d_v):
        p = total - w[:, k]
        if fresh is not None:
            p = torch.where(fresh, lv, p)
        msgs_v[:, k] = p.clamp(-clamp, clamp)
    return msgs_v


def vn_pass_regular_minsum(r_c, llr, msgs_v, tables: QCRegularTables,
                           clamp: float = 64.0, bits=None,
                           fresh=None) -> torch.Tensor:
    """Min-sum variable pass: r_c [R, d_c, Z, B], llr [C, Z, B] (message
    dtype; bfloat16 for fp8) -> msgs_v [C, d_v, Z, B] in place; ``bits``
    and ``fresh`` as in
    :func:`vn_pass_regular`. Returns msgs_v."""
    t = tables
    tensors = _check_vn_args(r_c, llr, msgs_v, bits, fresh, t)
    if _backend(t, *tensors, lib="qc_minsum") == "cpu":
        return vn_pass_minsum_plain(r_c, llr, msgs_v, t, clamp, bits, fresh)
    with torch.cuda.device(r_c.device):
        _kernels.vn_regular_minsum(r_c, llr, msgs_v, bits, fresh, t, clamp)
    return msgs_v


# ---- parity pass --------------------------------------------------------------

def parity_pass_plain(bits, syn, tables: QCRegularTables) -> torch.Tensor:
    """Plain PyTorch parity check (the counterpart of the CUDA kernel):
    [B] bool, True where any check of the lane is violated."""
    read = tables.cn_read
    x = bits[read[..., 0:1].long(), _rows(read, tables.Z)].to(torch.int32)
    acc = syn.to(torch.int32)
    for k in range(tables.d_c):
        acc = acc + x[:, k]
    return (acc & 1).amax(dim=(0, 1)) > 0


def parity_pass_regular(bits, syn, tables: QCRegularTables) -> torch.Tensor:
    """bits [C, Z, B] int8, syn [R, Z, B] int8 -> [B] bool, True where any
    check of the lane is violated."""
    t = tables
    B = bits.shape[-1]
    check(bits, "bits", (t.C, t.Z, B), (torch.int8,))
    check(syn, "syn", (t.R, t.Z, B), (torch.int8,))
    if _backend(t, bits, syn) == "cpu":
        return parity_pass_plain(bits, syn, t)
    return parity_kernel_flags(bits, syn, t) != 0


def parity_kernel_flags(bits, syn, tables: QCRegularTables,
                        lanes: int | None = None,
                        slice_lanes: int | None = None) -> torch.Tensor:
    """The parity kernel's launch on card tensors, over all checks: [B]
    int32 flags, 1 where violated; ``lanes`` and ``slice_lanes`` as in
    :func:`~ldpc_decoder_tpu_torch.ops.qc_grouped.parity_kernel_flags`."""
    flags = torch.zeros(bits.shape[-1], dtype=torch.int32,
                        device=bits.device)
    with torch.cuda.device(bits.device):
        _kernels.parity_regular(bits, syn, flags, tables, lanes, slice_lanes)
    return flags


# ---- message init and iteration runners -------------------------------------

def init_messages_qc_regular(llr, tables: QCRegularTables,
                             dtype=torch.float32,
                             pre: float = PRE_THRESHOLD,
                             alg: str = "sum-product", clamp: float = 64.0,
                             qscale: float = 4.0):
    """(msgs_v, r_c) for sorted llr [C, Z, B]: every slot of a variable
    gets φ(llr) in ``dtype`` (φ clamped at :func:`phi_high` of ``dtype``),
    or for min-sum the llr itself, unclipped
    (``qc_pallas.py:615-632``; ``clamp`` and ``qscale`` are taken for the
    families' one signature and not read). r_c is left uninitialised:
    every check pass rewrites all of it before any read."""
    t = tables
    B = llr.shape[-1]
    if alg == "min-sum":
        p = llr.to(torch.float32).to(dtype)
    else:
        p = phi(llr, pre, phi_high(dtype)).to(dtype)
    msgs_v = p[:, None].expand(t.C, t.d_v, t.Z, B).contiguous()
    r_c = torch.empty((t.R, t.d_c, t.Z, B), dtype=dtype, device=llr.device)
    return msgs_v, r_c


def _iteration(msgs_v, r_c, llr, syn, tables, pre, alg, beta, clamp, alpha,
               bits=None, fresh=None):
    if alg == "min-sum":
        cn_pass_regular_minsum(msgs_v, syn, r_c, tables, alpha, beta)
        vn_pass_regular_minsum(r_c, llr, msgs_v, tables, clamp, bits, fresh)
    else:
        cn_pass_regular(msgs_v, syn, r_c, tables, pre)
        vn_pass_regular(r_c, llr, msgs_v, tables, pre, bits, fresh)


def run_iterations_qc_regular(msgs, llr, syn, tables: QCRegularTables,
                              k: int, pre: float = PRE_THRESHOLD,
                              fresh=None, alg: str = "sum-product",
                              beta: float = 0.0, clamp: float = 64.0,
                              alpha=1.0, qscale: float = 4.0):
    """k flood iterations, the last one emitting hard decisions, then the
    parity check. ``msgs`` is the (msgs_v, r_c) pair, updated in place.
    ``alg`` and the min-sum parameters select the check rule (``qscale``
    is not read: this family has no int8).

    ``fresh`` ([B] bool or None): lanes refilled since the last call; the
    first iteration's VN pass emits init values for them (the emit
    iteration's when k = 1). Returns (msgs, bits [C, Z, B] int8,
    violated [B])."""
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    msgs_v, r_c = msgs
    rule = (pre, alg, beta, clamp, alpha)
    lo = 0
    if fresh is not None and k > 1:
        _iteration(msgs_v, r_c, llr, syn, tables, *rule, fresh=fresh)
        lo = 1
    for _ in range(lo, k - 1):
        _iteration(msgs_v, r_c, llr, syn, tables, *rule)
    bits = torch.empty((tables.C, tables.Z, llr.shape[-1]), dtype=torch.int8,
                       device=llr.device)
    _iteration(msgs_v, r_c, llr, syn, tables, *rule, bits=bits,
               fresh=fresh if k == 1 else None)
    violated = parity_pass_regular(bits, syn, tables)
    return (msgs_v, r_c), bits, violated


def burst_iterations_qc_regular(msgs, llr, syn, tables: QCRegularTables,
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
                   alpha)
    return msgs_v, r_c
