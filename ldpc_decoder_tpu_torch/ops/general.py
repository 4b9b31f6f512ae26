"""General (any-alist) passes: tables, plain passes, kernels.

Port of ``ldpc_decoder_tpu/ops/general_pallas.py``, the path for codes with
no QC structure to exploit. Variables and checks are sorted by degree
(:func:`..codes.compiled.compile_code`), so each degree bucket is a
contiguous node range.

Layout: **plane-major buckets, unpadded**. Slot k of node i of a degree-d
bucket of ``count`` nodes sits at edge row ``edge_start + k·count + i``
(the JAX layout with ``count_pad = count``: its pad rows and ``valid_c``
exist only for Pallas tiles). Frames are on the last axis: ``msgs_v [E,
B]`` holds the variable-to-check messages in variable order, ``r_c [E, B]``
the check-to-variable messages in check order, ``llr`` and ``bits
[n_vars, B]``, ``syn [n_checks, B]`` int8, all in sorted node order.

One iteration is a check pass then a variable pass. The JAX path gathers
between them (``m_c = take(msgs_v, perm_v2c)``, ``r_v = take(r_c,
perm_c2v)``, ``general_pallas.py:573,576``) because a gather inside a
Pallas kernel was out of reach; here the kernels fuse the gather: the check
kernel reads ``msgs_v[perm_v2c[row]]``, the variable kernel reads
``r_c[perm_c2v[row]]``. The state is two edge arrays instead of four, and
every pass writes its output in place.

Each pass has a plain PyTorch version (``*_plain``: it gathers with
``index_select`` first, then runs the bucket stream in the kernel's
summation order) and a kernel (csrc/general.cuh for sum-product,
csrc/general.cu for min-sum, via :mod:`._kernels`, one launch per degree
bucket). The pass functions dispatch on the tensors' device: CPU tensors
take the plain version; CUDA tensors launch the kernel or raise — there is
no fallback. The sum-product kernels evaluate φ from the card's MUFU
operations (the decoder's); their internal ``_phi="accurate"`` keyword
selects the plain version's φ instead, as on the QC passes. On
float8_e5m2 messages the decoder's kernels (csrc/general_e5m2.cuh) take φ
and the store as one lookup in a table of thresholds: φ correctly rounded
to e5m2 (:func:`~.phi.phi_e5m2`). Their plain twins,
:func:`cn_pass_general_e5m2_plain` and :func:`vn_pass_general_e5m2_plain`,
give their bits; the CPU path keeps the plain passes above, which the CPU
tests hold to the JAX package bit for bit.

Check and variable rules (``general_pallas.py:252-367``):

- sum-product check: ext = Σ|m_j|, out_k = φ_abs(ext − |m_k|) with the
  sign-bit algebra X = (syn ⊕ d odd)<<31 ⊕ (⊕_j sb_j), sign_k = sb_k ⊕ X;
- sum-product variable: tot = llr + Σ r_j, rounded through the message
  dtype before pre_k = tot − r_k; out_k = copysign(φ_abs(|pre_k|), pre_k);
  bits = ¬signbit(tot), so −0 decodes as 0 (flood.cu:180);
- min-sum check: a two-minimum scan with ties to the first minimum (a sole
  edge has m2 = 0); |out_k| = max(α_d·(min over j ≠ k) − β, 0), sign as
  above;
- min-sum variable: pre_k = tot − r_k, or the llr exactly when d = 1,
  clipped to ±clamp.

int8 messages (min-sum only) are dequantized on read (× 1/qscale) and
quantized on write (:func:`.qc_decode.quantize_msgs`). float8_e5m2 messages
(sum-product and min-sum, with a bfloat16 llr: :func:`.qc_decode.llr_dtype`)
are widened exactly on read and rounded to nearest even on write, a value
that rounds to zero keeping its sign; the variable total is rounded through
float8_e5m2 before tot − r_k. The JAX package runs float8_e5m2 without QC
structure on its XLA path (``ldpc_decoder_tpu/ops/decode.py``: φ clamped to
[pre, 80], ``bp_iteration``'s ``t_edge``, ``cn_update_minsum``,
``vn_update_minsum``), which keeps its state in check-edge order; these
passes compute the same values in the plane-major layout, and the kernels
are their float8 instantiations (``csrc/general_fp8.cu``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ldpc_decoder_tpu_torch.codes.compiled import CompiledCode, DegreeBucket
from ldpc_decoder_tpu_torch.ops import _kernels
from ldpc_decoder_tpu_torch.ops._dispatch import backend, check
from ldpc_decoder_tpu_torch.ops.phi import (
    PRE_THRESHOLD,
    phi,
    phi_abs,
    phi_e5m2,
    phi_e5m2_codes,
)
from ldpc_decoder_tpu_torch.ops.qc_decode import (
    llr_dtype,
    minsum_magnitudes,
    msgs_to_f32,
    quantize_msgs,
    resolve_minsum_alpha,
    signed_f32,
    store_msgs,
)

_SP_DTYPES = (torch.float32, torch.bfloat16, torch.float8_e5m2)
_MS_DTYPES = (torch.float32, torch.bfloat16, torch.int8, torch.float8_e5m2)
_SIGN = -(1 << 31)  # the float32 sign bit as an int32


def _edge_map(buckets, n_edges: int) -> np.ndarray:
    """Sorted node-major edge row -> plane-major edge row."""
    out = np.empty(n_edges, dtype=np.int64)
    for b in buckets:
        local = np.arange(b.count * b.degree, dtype=np.int64)
        i, k = local // b.degree, local % b.degree
        out[b.edge_start + local] = b.edge_start + k * b.count + i
    return out


@dataclasses.dataclass(frozen=True)
class GeneralTables:
    """Degree buckets and edge permutations of one code in the plane-major
    layout; the tensors sit on one device."""

    n_vars: int
    n_checks: int
    n_edges: int
    vn_buckets: tuple[DegreeBucket, ...]
    cn_buckets: tuple[DegreeBucket, ...]

    perm_v2c: torch.Tensor       # [E] int32 check-layout row -> variable row
    perm_c2v: torch.Tensor       # [E] int32 variable-layout row -> check row
    cn_edge_vnrow: torch.Tensor  # [E] int32 check-layout row -> variable node
    vn_pos: torch.Tensor         # [n_vars] int32 natural -> sorted variable
    vn_order: torch.Tensor       # [n_vars] int32 sorted -> natural variable
    cn_order: torch.Tensor       # [n_checks] int32 sorted -> natural check
    erased_mask_sorted: torch.Tensor  # [n_vars, 1] bool

    @property
    def device(self) -> torch.device:
        return self.perm_v2c.device

    @property
    def max_degree(self) -> int:
        return max(b.degree for b in self.vn_buckets + self.cn_buckets)

    @staticmethod
    def from_compiled(cc: CompiledCode,
                      device: torch.device | str) -> "GeneralTables":
        code = cc.code
        vedge = _edge_map(cc.vn_buckets, code.n_edges)
        cedge = _edge_map(cc.cn_buckets, code.n_edges)
        perm_v2c = np.empty(code.n_edges, dtype=np.int32)
        perm_v2c[cedge] = vedge[np.asarray(cc.perm_v2c, dtype=np.int64)]
        perm_c2v = np.empty(code.n_edges, dtype=np.int32)
        perm_c2v[vedge] = cedge[np.asarray(cc.perm_c2v, dtype=np.int64)]
        cn_edge_vnrow = np.empty(code.n_edges, dtype=np.int32)
        cn_edge_vnrow[cedge] = cc.cn_edge_vnrow
        erased_nat = np.zeros(code.n_vars, dtype=bool)
        if code.n_erased_vars:
            erased_nat[code.n_vars - code.n_erased_vars:] = True

        def dev(a, dtype=np.int32):
            return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

        return GeneralTables(
            n_vars=code.n_vars, n_checks=code.n_checks,
            n_edges=code.n_edges,
            vn_buckets=cc.vn_buckets, cn_buckets=cc.cn_buckets,
            perm_v2c=dev(perm_v2c), perm_c2v=dev(perm_c2v),
            cn_edge_vnrow=dev(cn_edge_vnrow),
            vn_pos=dev(cc.vn_pos), vn_order=dev(cc.vn_order),
            cn_order=dev(cc.cn_order),
            erased_mask_sorted=dev(erased_nat[cc.vn_order], bool)[:, None],
        )


def _backend(tables: GeneralTables, *tensors: torch.Tensor) -> str:
    return backend(tables.device, tables.max_degree,
                   _kernels.MAX_DEGREES["general"], *tensors)


def _planes(x: torch.Tensor, b: DegreeBucket) -> torch.Tensor:
    """[d, count, B] view of one bucket's plane-major edge rows."""
    return x[b.edge_start:b.edge_start + b.degree * b.count].view(
        b.degree, b.count, x.shape[-1])


def _nodes(x: torch.Tensor, b: DegreeBucket) -> torch.Tensor:
    return x[b.row_start:b.row_start + b.count]


def _check_edges(msgs_v, syn, r_c, t: GeneralTables, dtypes):
    B = msgs_v.shape[-1]
    check(msgs_v, "msgs_v", (t.n_edges, B), dtypes)
    check(r_c, "r_c", (t.n_edges, B), (msgs_v.dtype,))
    check(syn, "syn", (t.n_checks, B), (torch.int8,))
    return _backend(t, msgs_v, syn, r_c)


def _check_vars(r_c, llr, msgs_v, bits, t: GeneralTables, dtypes):
    B = r_c.shape[-1]
    check(r_c, "r_c", (t.n_edges, B), dtypes)
    check(msgs_v, "msgs_v", (t.n_edges, B), (r_c.dtype,))
    check(llr, "llr", (t.n_vars, B), (llr_dtype(r_c.dtype),))
    tensors = [r_c, llr, msgs_v]
    if bits is not None:
        check(bits, "bits", (t.n_vars, B), (torch.int8,))
        tensors.append(bits)
    return _backend(t, *tensors)


# ---- sum-product check pass ---------------------------------------------------

def cn_pass_general_plain(msgs_v, syn, r_c, tables: GeneralTables,
                          pre: float = PRE_THRESHOLD) -> torch.Tensor:
    """Plain PyTorch sum-product check pass (the counterpart of the CUDA
    kernel): gather m_c = msgs_v[perm_v2c], then per bucket r_c[k] =
    φ_abs(Σ_j |m_j| − |m_k|) with the sign-bit algebra."""

    def store(out, x, sign):
        out.copy_(signed_f32(phi_abs(x, pre), sign))

    return _cn_general_plain(msgs_v, syn, r_c, tables, store)


def cn_pass_general_e5m2_plain(msgs_v, syn, r_c, tables: GeneralTables,
                               pre: float = PRE_THRESHOLD) -> torch.Tensor:
    """Plain version of the float8_e5m2 check kernel that the decoder
    launches (csrc/general_e5m2.cuh), bit for bit: the sums and the sign
    algebra of :func:`cn_pass_general_plain`, φ correctly rounded to e5m2
    by the threshold table (:func:`~.phi.phi_e5m2_codes`) and the sign
    bit OR-ed into the byte."""
    check(msgs_v, "msgs_v", msgs_v.shape, (torch.float8_e5m2,))

    def store(out, x, sign):
        code = phi_e5m2_codes(x, pre) | ((sign != 0).to(torch.uint8) << 7)
        out.view(torch.uint8).copy_(code)

    return _cn_general_plain(msgs_v, syn, r_c, tables, store)


def _cn_general_plain(msgs_v, syn, r_c, tables: GeneralTables, store):
    """The check pass's gather, sums and sign algebra; ``store(out_k, x,
    sign)`` writes slot k's message from x = ext − |m_k| (float32) and its
    sign bit (int32, 0 or the sign bit)."""
    m_c = msgs_v.index_select(0, tables.perm_v2c)
    for b in tables.cn_buckets:
        d, m = b.degree, _planes(m_c, b)
        out = _planes(r_c, b)
        X = _nodes(syn, b).to(torch.int32) * _SIGN
        if d % 2:
            X = X ^ _SIGN
        ext = None
        for k in range(d):  # left to right, as the kernel sums
            mk = m[k].to(torch.float32)
            X = X ^ (mk.view(torch.int32) & _SIGN)
            ext = mk.abs() if ext is None else ext + mk.abs()
        for k in range(d):
            mk = m[k].to(torch.float32)
            store(out[k], ext - mk.abs(), (mk.view(torch.int32) & _SIGN) ^ X)
    return r_c


def cn_pass_general(msgs_v, syn, r_c, tables: GeneralTables,
                    pre: float = PRE_THRESHOLD, *,
                    _phi: str = "fast") -> torch.Tensor:
    """msgs_v [E, B] (variable order), syn [n_checks, B] int8 -> r_c [E, B]
    (check order), rewritten in place; returns r_c.

    ``_phi`` (internal: the tests and chip_smoke.py) selects the kernel's φ:
    "fast" (MUFU and FMA, what the decoder runs) or "accurate" (the
    accurate tanhf/logf/expf, the plain version's arithmetic). The plain
    version has one φ and ignores it."""
    _kernels.check_phi(_phi)
    if _check_edges(msgs_v, syn, r_c, tables, _SP_DTYPES) == "cpu":
        return cn_pass_general_plain(msgs_v, syn, r_c, tables, pre)
    with torch.cuda.device(msgs_v.device):
        for b in tables.cn_buckets:
            _kernels.cn_general(msgs_v, syn, r_c, tables.perm_v2c, b, pre,
                                _phi)
    return r_c


# ---- sum-product variable pass ------------------------------------------------

def vn_pass_general_plain(r_c, llr, msgs_v, tables: GeneralTables,
                          pre: float = PRE_THRESHOLD,
                          bits=None) -> torch.Tensor:
    """Plain PyTorch sum-product variable pass (the counterpart of the CUDA
    kernel): gather r_v = r_c[perm_c2v], then per bucket tot = llr + (r_0
    + r_1 + ...), rounded through the message dtype; slot k gets
    φ(tot − r_k); bits = ¬signbit(tot)."""

    def store(out, p):
        out.copy_(phi(p, pre))

    return _vn_general_plain(r_c, llr, msgs_v, tables, bits, store)


def vn_pass_general_e5m2_plain(r_c, llr, msgs_v, tables: GeneralTables,
                               pre: float = PRE_THRESHOLD,
                               bits=None) -> torch.Tensor:
    """Plain version of the float8_e5m2 variable kernel that the decoder
    launches (csrc/general_e5m2.cuh), bit for bit: the sums, the total
    rounded through float8_e5m2 and the hard bits of
    :func:`vn_pass_general_plain`, slot k's message φ(tq − r_k) correctly
    rounded to e5m2 by the threshold table (:func:`~.phi.phi_e5m2`), its
    sign that of tq − r_k. The total rounds as torch rounds (±inf from
    61440 up); the kernel saturates at 57344 instead, which gives the same
    bytes (tests/test_torch_phi_e5m2.py)."""
    check(r_c, "r_c", r_c.shape, (torch.float8_e5m2,))

    def store(out, p):
        out.view(torch.uint8).copy_(phi_e5m2(p, pre).view(torch.uint8))

    return _vn_general_plain(r_c, llr, msgs_v, tables, bits, store)


def _vn_general_plain(r_c, llr, msgs_v, tables: GeneralTables, bits, store):
    """The variable pass's gather, sums, rounded total and hard bits;
    ``store(out_k, p)`` writes slot k's message from p = tq − r_k
    (float32)."""
    r_v = r_c.index_select(0, tables.perm_c2v)
    for b in tables.vn_buckets:
        r = _planes(r_v, b)
        out = _planes(msgs_v, b)
        s = r[0].to(torch.float32)
        for k in range(1, b.degree):
            s = s + r[k].to(torch.float32)
        tot = _nodes(llr, b).to(torch.float32) + s
        if bits is not None:
            _nodes(bits, b).copy_(~torch.signbit(tot))
        tq = tot.to(msgs_v.dtype).to(torch.float32)
        for k in range(b.degree):
            store(out[k], tq - r[k].to(torch.float32))
    return msgs_v


def vn_pass_general(r_c, llr, msgs_v, tables: GeneralTables,
                    pre: float = PRE_THRESHOLD, bits=None, *,
                    _phi: str = "fast") -> torch.Tensor:
    """r_c [E, B] (check order), llr [n_vars, B] (message dtype; bfloat16
    for float8_e5m2) -> msgs_v [E, B] (variable order) in place; returns
    msgs_v. ``bits`` ([n_vars, B]
    int8 or None): emit hard decisions into it. ``_phi`` as in
    :func:`cn_pass_general`."""
    _kernels.check_phi(_phi)
    if _check_vars(r_c, llr, msgs_v, bits, tables, _SP_DTYPES) == "cpu":
        return vn_pass_general_plain(r_c, llr, msgs_v, tables, pre, bits)
    with torch.cuda.device(r_c.device):
        for b in tables.vn_buckets:
            _kernels.vn_general(r_c, llr, msgs_v, bits, tables.perm_c2v, b,
                                pre, _phi)
    return msgs_v


# ---- min-sum check pass ---------------------------------------------------------

def cn_pass_general_minsum_plain(msgs_v, syn, r_c, tables: GeneralTables,
                                 alpha=1.0, beta: float = 0.0,
                                 qscale: float = 4.0) -> torch.Tensor:
    """Plain PyTorch min-sum check pass (the counterpart of the CUDA
    kernel): gather, then per bucket the two-minimum scan (ties to the
    first minimum; m2 = 0 for a sole edge) and |out_k| = max(α_d·other −
    β, 0) with the sign-bit algebra; int8 quantized on write."""
    m_c = msgs_v.index_select(0, tables.perm_v2c)
    for b in tables.cn_buckets:
        d, m = b.degree, _planes(m_c, b)
        out = _planes(r_c, b)
        X = _nodes(syn, b).to(torch.int32) * _SIGN
        if d % 2:
            X = X ^ _SIGN
        mk = [msgs_to_f32(m[k], qscale) for k in range(d)]
        sb = [x.view(torch.int32) & _SIGN for x in mk]
        for k in range(d):
            X = X ^ sb[k]
        res = minsum_magnitudes([x.abs() for x in mk],
                                resolve_minsum_alpha(alpha, d), beta)
        for k in range(d):
            store_msgs(out[k], signed_f32(res[k], sb[k] ^ X), qscale)
    return r_c


def cn_pass_general_minsum(msgs_v, syn, r_c, tables: GeneralTables,
                           alpha=1.0, beta: float = 0.0,
                           qscale: float = 4.0) -> torch.Tensor:
    """Min-sum check pass: msgs_v [E, B] (f32, bf16, int8 or float8_e5m2)
    -> r_c [E, B] in place; ``alpha`` a float or (degree, α) pairs; ``qscale`` is read for
    int8 messages only. Returns r_c."""
    if _check_edges(msgs_v, syn, r_c, tables, _MS_DTYPES) == "cpu":
        return cn_pass_general_minsum_plain(msgs_v, syn, r_c, tables, alpha,
                                            beta, qscale)
    with torch.cuda.device(msgs_v.device):
        for b in tables.cn_buckets:
            _kernels.cn_general_minsum(
                msgs_v, syn, r_c, tables.perm_v2c, b,
                resolve_minsum_alpha(alpha, b.degree), beta, qscale)
    return r_c


# ---- min-sum variable pass ------------------------------------------------------

def vn_pass_general_minsum_plain(r_c, llr, msgs_v, tables: GeneralTables,
                                 clamp: float = 64.0, qscale: float = 4.0,
                                 bits=None) -> torch.Tensor:
    """Plain PyTorch min-sum variable pass (the counterpart of the CUDA
    kernel): gather, then per bucket tot = llr + (r_0 + r_1 + ...); slot k
    gets clip(tot − r_k, ±clamp), or clip(llr) when d = 1; int8 quantized
    on write; bits = ¬signbit(tot)."""
    r_v = r_c.index_select(0, tables.perm_c2v)
    for b in tables.vn_buckets:
        r = _planes(r_v, b)
        out = _planes(msgs_v, b)
        s = msgs_to_f32(r[0], qscale)
        for k in range(1, b.degree):
            s = s + msgs_to_f32(r[k], qscale)
        lv = _nodes(llr, b).to(torch.float32)
        tot = lv + s
        if bits is not None:
            _nodes(bits, b).copy_(~torch.signbit(tot))
        for k in range(b.degree):
            p = lv if b.degree == 1 else tot - msgs_to_f32(r[k], qscale)
            store_msgs(out[k], p.clamp(-clamp, clamp), qscale)
    return msgs_v


def vn_pass_general_minsum(r_c, llr, msgs_v, tables: GeneralTables,
                           clamp: float = 64.0, qscale: float = 4.0,
                           bits=None) -> torch.Tensor:
    """Min-sum variable pass: r_c [E, B] (f32, bf16, int8 or float8_e5m2),
    llr [n_vars, B] (the message dtype; bfloat16 for the 1-byte ones) ->
    msgs_v [E, B] in place;
    ``bits`` as in :func:`vn_pass_general`. Returns msgs_v."""
    if _check_vars(r_c, llr, msgs_v, bits, tables, _MS_DTYPES) == "cpu":
        return vn_pass_general_minsum_plain(r_c, llr, msgs_v, tables, clamp,
                                            qscale, bits)
    with torch.cuda.device(r_c.device):
        for b in tables.vn_buckets:
            _kernels.vn_general_minsum(r_c, llr, msgs_v, bits,
                                       tables.perm_c2v, b, clamp, qscale)
    return msgs_v


# ---- parity, message init and iteration runners ---------------------------------

def parity_violations_general(bits, syn, tables: GeneralTables) -> torch.Tensor:
    """[B] bool: True where any check of the lane is violated
    (``general_pallas.py:512-532``). Plain PyTorch on every device (XLA in
    the JAX package, not a kernel); the per-check sums stay in int8, so
    the only edge-sized temporary is the gathered bits."""
    B = bits.shape[-1]
    check(bits, "bits", (tables.n_vars, B), (torch.int8,))
    check(syn, "syn", (tables.n_checks, B), (torch.int8,))
    bits_c = bits.index_select(0, tables.cn_edge_vnrow)
    viol = torch.zeros(B, dtype=torch.bool, device=bits.device)
    for b in tables.cn_buckets:
        acc = torch.int8 if b.degree <= 126 else torch.int32
        x = _planes(bits_c, b).sum(dim=0, dtype=acc)
        x = x + _nodes(syn, b).to(acc)
        viol |= ((x & 1) > 0).any(dim=0)
    return viol


def init_messages_general(llr, tables: GeneralTables, dtype=torch.float32,
                          pre: float = PRE_THRESHOLD,
                          alg: str = "sum-product", clamp: float = 64.0,
                          qscale: float = 4.0):
    """(msgs_v, r_c) for sorted llr [n_vars, B]: msgs_v from
    :func:`init_variable_messages_general`; r_c is left uninitialised:
    every check pass rewrites all of it before any read."""
    msgs_v = init_variable_messages_general(llr, tables, dtype, pre, alg,
                                            clamp, qscale)
    return msgs_v, torch.empty_like(msgs_v)


def init_variable_messages_general(llr, tables: GeneralTables,
                                   dtype=torch.float32,
                                   pre: float = PRE_THRESHOLD,
                                   alg: str = "sum-product",
                                   clamp: float = 64.0,
                                   qscale: float = 4.0) -> torch.Tensor:
    """msgs_v [E, B] for sorted llr [n_vars, B]: every slot of a variable
    gets φ(llr) for sum-product, the llr itself for min-sum (clipped and
    quantized for int8) (``general_pallas.py:535-568``)."""
    if alg == "min-sum":
        if dtype == torch.int8:
            p = quantize_msgs(llr.to(torch.float32).clamp(-clamp, clamp),
                              qscale)
        else:
            p = llr.to(dtype)
    else:
        p = phi(llr, pre).to(dtype)
    B = llr.shape[-1]
    msgs_v = torch.empty((tables.n_edges, B), dtype=dtype, device=llr.device)
    for b in tables.vn_buckets:
        _planes(msgs_v, b).copy_(_nodes(p, b)[None].expand(b.degree, -1, -1))
    return msgs_v


def _iteration(msgs_v, r_c, llr, syn, tables, pre, alg, beta, clamp, alpha,
               qscale, bits=None):
    if alg == "min-sum":
        cn_pass_general_minsum(msgs_v, syn, r_c, tables, alpha, beta, qscale)
        vn_pass_general_minsum(r_c, llr, msgs_v, tables, clamp, qscale, bits)
    else:
        cn_pass_general(msgs_v, syn, r_c, tables, pre)
        vn_pass_general(r_c, llr, msgs_v, tables, pre, bits)


def run_iterations_general(msgs, llr, syn, tables: GeneralTables, k: int,
                           pre: float = PRE_THRESHOLD,
                           alg: str = "sum-product", beta: float = 0.0,
                           clamp: float = 64.0, alpha=1.0,
                           qscale: float = 4.0):
    """k flood iterations, the last one emitting hard decisions, then the
    parity check. ``msgs`` is the (msgs_v, r_c) pair, updated in place.
    Returns (msgs, bits [n_vars, B] int8, violated [B])."""
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    msgs_v, r_c = msgs
    for _ in range(k - 1):
        _iteration(msgs_v, r_c, llr, syn, tables, pre, alg, beta, clamp,
                   alpha, qscale)
    bits = torch.empty((tables.n_vars, llr.shape[-1]), dtype=torch.int8,
                       device=llr.device)
    _iteration(msgs_v, r_c, llr, syn, tables, pre, alg, beta, clamp, alpha,
               qscale, bits)
    return (msgs_v, r_c), bits, parity_violations_general(bits, syn, tables)


def burst_iterations_general(msgs, llr, syn, tables: GeneralTables, b: int,
                             pre: float = PRE_THRESHOLD,
                             alg: str = "sum-product", beta: float = 0.0,
                             clamp: float = 64.0, alpha=1.0,
                             qscale: float = 4.0):
    """``b`` plain iterations with no emit and no parity check (the
    delayed-first-check phase). Updates ``msgs`` in place."""
    msgs_v, r_c = msgs
    for _ in range(b):
        _iteration(msgs_v, r_c, llr, syn, tables, pre, alg, beta, clamp,
                   alpha, qscale)
    return msgs_v, r_c
