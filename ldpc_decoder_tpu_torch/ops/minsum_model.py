"""The min-sum check row of ``csrc/minsum.cuh`` in numpy, step for step.

The grouped and general min-sum check kernels read each slot once, keep per
lane the two smallest magnitudes, where the first sits and the sign bits,
store the two outgoing magnitudes once (``s1``, ``s2``) and give each slot
``pos == k ? s2 : s1`` with its sign set in the stored representation. This
module restates that arithmetic on the stored bits, so the CPU tests can
hold it bit for bit to the plain passes (``ops/qc_grouped.py``
``cn_pass_minsum_plain``, ``ops/general.py``
``cn_pass_general_minsum_plain``), which compute every slot's magnitude in
float32 and round each one, and to the JAX kernels.

:func:`check_rows` is the scalar path (one lane at a time: float32,
bfloat16, and every dtype's one-lane instantiation);
:func:`check_rows_packed` the vector path of the 1-byte dtypes, which
works on words of four lanes (``check_row_packed``). Stored messages are
numpy arrays by kind: ``"float32"`` (float32), ``"bfloat16"`` (uint16
bits), ``"float8_e5m2"`` (uint8 bits) and ``"int8"`` (int8 steps of
1/qscale). :func:`to_bits` and :func:`from_bits` carry torch
tensors across.
"""

from __future__ import annotations

import numpy as np
import torch

KINDS = {torch.float32: "float32", torch.bfloat16: "bfloat16",
         torch.float8_e5m2: "float8_e5m2", torch.int8: "int8"}
# the bit views of the 16- and 8-bit kinds: (torch dtype, numpy dtype)
_BITS = {"bfloat16": (torch.int16, np.int16),
         "float8_e5m2": (torch.uint8, np.uint8)}
_UNSIGNED = {"bfloat16": np.uint16, "float8_e5m2": np.uint8}
_SIGN_SHIFT = {"float32": 31, "bfloat16": 15, "float8_e5m2": 7}


def to_bits(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """A CPU tensor of messages as (stored array, kind)."""
    kind = KINDS[t.dtype]
    t = t.contiguous()
    if kind in _BITS:
        return t.view(_BITS[kind][0]).numpy().view(_UNSIGNED[kind]), kind
    return t.numpy(), kind


def from_bits(a: np.ndarray, kind: str) -> torch.Tensor:
    """The inverse of :func:`to_bits`."""
    a = np.ascontiguousarray(a)
    if kind in _BITS:
        dtype = next(d for d, k in KINDS.items() if k == kind)
        return torch.from_numpy(a.view(_BITS[kind][1])).view(dtype)
    return torch.from_numpy(a)


def magnitude(m: np.ndarray, kind: str) -> np.ndarray:
    """``Msg<T>::mag``: the stored magnitude as an integer (uint32): the
    bits without the sign, or |q| for int8."""
    if kind == "int8":
        return np.abs(m.astype(np.int32)).astype(np.uint32)
    bits = m.view(np.uint32) if kind == "float32" else m.astype(np.uint32)
    return bits & np.uint32((1 << _SIGN_SHIFT[kind]) - 1)


def sign(m: np.ndarray, kind: str) -> np.ndarray:
    """``Msg<T>::sign``: 1 where the stored sign bit is set (int8: q < 0)."""
    if kind == "int8":
        return (m < 0).astype(np.uint32)
    bits = m.view(np.uint32) if kind == "float32" else m.astype(np.uint32)
    return bits >> np.uint32(_SIGN_SHIFT[kind])


def widen(mag: np.ndarray, kind: str, qscale: float) -> np.ndarray:
    """``Msg<T>::widen``: a magnitude as float32 (int8: |q| · (1/qscale))."""
    if kind == "float32":
        return mag.astype(np.uint32).view(np.float32)
    if kind == "bfloat16":
        return (mag.astype(np.uint32) << np.uint32(16)).view(np.float32)
    if kind == "float8_e5m2":
        return (mag.astype(np.uint16) << np.uint16(8)).view(
            np.float16).astype(np.float32)
    return mag.astype(np.float32) * np.float32(1.0 / qscale)


def fp8_e5m2_bits(v: np.ndarray) -> np.ndarray:
    """common.cuh ``fp8_e5m2_bits``: float32 -> e5m2 bits, round to nearest
    even, overflow to ±inf, NaN to 0x7F, the sign split off and set back."""
    bits = v.astype(np.float32).view(np.uint32)
    sgn = bits & np.uint32(0x80000000)
    bits = bits ^ sgn
    inf, fp8_max, denorm = 255 << 23, 143 << 23, np.uint32(134 << 23)
    with np.errstate(over="ignore", invalid="ignore"):
        sub = (bits.view(np.float32) + denorm.view(np.float32)).view(
            np.uint32) - denorm
    mant_odd = (bits >> np.uint32(21)) & np.uint32(1)
    rebias = np.uint32((((15 - 127) << 23) + 0xFFFFF) % 2**32)
    normal = (bits + rebias + mant_odd) >> np.uint32(21)  # mod 2^32
    r = np.where(bits >= fp8_max, np.where(bits > inf, 0x7F, 0x7C),
                 np.where(bits < (113 << 23), sub, normal))
    return (r.astype(np.uint32) & np.uint32(0xFF)).astype(np.uint8) | (
        sgn >> np.uint32(24)).astype(np.uint8)


def store(v: np.ndarray, kind: str, qscale: float) -> np.ndarray:
    """``Msg<T>::store``: float32 -> stored (bfloat16 round to nearest even,
    e5m2 by :func:`fp8_e5m2_bits`, int8 rint at qscale saturated at ±127)."""
    v = v.astype(np.float32)
    if kind == "float32":
        return v
    if kind == "bfloat16":
        bits = v.view(np.uint32)
        odd = (bits >> np.uint32(16)) & np.uint32(1)
        return ((bits + np.uint32(0x7FFF) + odd) >> np.uint32(16)).astype(
            np.uint16)
    if kind == "float8_e5m2":
        return fp8_e5m2_bits(v)
    q = np.rint(v * np.float32(qscale))
    return np.clip(q, -127.0, 127.0).astype(np.int8)


def with_sign(s: np.ndarray, neg: np.ndarray, kind: str) -> np.ndarray:
    """``Msg<T>::with_sign``: a stored magnitude with the sign ``neg`` (0 or
    1): the sign bit OR-ed in, or the int8 step negated."""
    if kind == "int8":
        return np.where(neg != 0, -s.astype(np.int32), s).astype(np.int8)
    if kind == "float32":
        return (s.view(np.uint32) | (neg.astype(np.uint32) << np.uint32(31))
                ).view(np.float32)
    dt = s.dtype
    return (s.astype(np.uint32) | (neg.astype(np.uint32)
                                   << np.uint32(_SIGN_SHIFT[kind]))).astype(dt)


def check_rows(m: np.ndarray, syn: np.ndarray, kind: str, alpha: float,
               beta: float, qscale: float) -> np.ndarray:
    """``check_row``: ``m`` [D, ...] stored incoming messages (slot first),
    ``syn`` [...] the syndrome bits; the [D, ...] stored outgoing ones."""
    m = np.ascontiguousarray(m)
    D = m.shape[0]
    big = np.uint32(0xFFFFFFFF)
    k1 = np.full(m.shape[1:], big)  # float32: the smallest magnitude
    k2 = np.full(m.shape[1:], big)  # float32: the second
    pos = np.zeros(m.shape[1:], np.int64)
    signs = np.zeros(m.shape[1:], np.uint32)
    for k in range(D):  # the read pass
        mag = magnitude(m[k], kind)
        if kind == "float32":  # compare and select
            new = mag < k1
            k2 = np.where(new, k1, np.minimum(k2, mag))
            k1 = np.where(new, mag, k1)
            pos = np.where(new, k, pos)
        else:  # the two smallest keys |m| << 5 | k
            key = (mag << np.uint32(5)) | np.uint32(k)
            k2 = np.minimum(k2, np.maximum(k1, key))
            k1 = np.minimum(k1, key)
        signs |= sign(m[k], kind) << np.uint32(k)
    if kind != "float32":
        k1, k2, pos = k1 >> np.uint32(5), k2 >> np.uint32(5), k1 & 31
    x = (syn.astype(np.uint32) ^ np.uint32(D & 1)
         ^ np.bitwise_count(signs).astype(np.uint32)) & np.uint32(1)
    signs ^= np.uint32(0) - x
    m1 = widen(k1, kind, qscale)
    m2 = np.zeros_like(m1) if D == 1 else widen(k2, kind, qscale)
    a, b = np.float32(alpha), np.float32(beta)
    s1 = store(np.fmax(a * m1 - b, np.float32(0.0)), kind, qscale)
    s2 = store(np.fmax(a * m2 - b, np.float32(0.0)), kind, qscale)
    return np.stack([  # the write pass
        with_sign(np.where(pos == k, s2, s1),
                  (signs >> np.uint32(k)) & np.uint32(1), kind)
        for k in range(D)])


# ---- the 1-byte vector path: four lanes a 32-bit word -----------------------

_U32 = np.uint32


def prmt(a: np.ndarray, b: np.ndarray, s: int) -> np.ndarray:
    """PTX ``prmt.b32`` (default mode) on uint32 arrays: result byte i is
    byte ``(s >> 4i) & 7`` of {a, b}, its sign replicated when bit 3 of the
    nibble is set."""
    a, b = np.asarray(a, _U32), np.asarray(b, _U32)
    src = [(a >> _U32(8 * i)) & _U32(0xFF) for i in range(4)] + [
        (b >> _U32(8 * i)) & _U32(0xFF) for i in range(4)]
    r = np.zeros(np.broadcast(a, b).shape, _U32)
    for i in range(4):
        nib = (s >> (4 * i)) & 0xF
        v = src[nib & 7]
        if nib & 8:
            v = np.where(v & _U32(0x80), _U32(0xFF), _U32(0))
        r |= v << _U32(8 * i)
    return r


def _u16x2(op, a, b):
    lo = op(a & _U32(0xFFFF), b & _U32(0xFFFF))
    hi = op(a >> _U32(16), b >> _U32(16))
    return (hi << _U32(16)) | lo


def check_rows_packed(m: np.ndarray, syn: np.ndarray, kind: str,
                      alpha: float, beta: float,
                      qscale: float) -> np.ndarray:
    """``check_row_packed``, the vector path of the int8 and float8_e5m2
    rows, word for word: ``m`` [D, ..., L] stored messages with the lanes
    last (L a multiple of 4), ``syn`` [..., L]; the [D, ..., L] stored
    outgoing messages."""
    m = np.ascontiguousarray(m)
    D = m.shape[0]
    words = m.view(_U32)  # [D, ..., L / 4]
    sy = np.ascontiguousarray(syn.astype(np.int8)).view(_U32)
    with np.errstate(invalid="ignore"):  # the e5m2 NaN patterns
        table = store(np.fmax(
            np.float32(alpha) * widen(np.arange(256, dtype=_U32), kind,
                                      qscale)
            - np.float32(beta), np.float32(0.0)), kind, qscale).view(np.uint8)
    k1 = [np.full(words.shape[1:], _U32(0xFFFFFFFF)) for _ in range(2)]
    k2 = [np.full(words.shape[1:], _U32(0xFFFFFFFF)) for _ in range(2)]
    sg = [np.zeros(words.shape[1:], _U32) for _ in range((D + 7) // 8)]
    for k in range(D):  # the read pass
        w = words[k]
        if kind == "int8":
            n = prmt(w, 0, 0xBA98)
            sgn = n & _U32(0x01010101)
            mag = (w ^ n) + sgn
        else:
            sgn = (w >> _U32(7)) & _U32(0x01010101)
            mag = w & _U32(0x7F7F7F7F)
        sg[k // 8] |= sgn << _U32(k % 8)
        kk = _U32(0x01010101 * k)
        for h in range(2):
            key = prmt(mag, kk, 0x3424 if h else 0x1404)
            k2[h] = _u16x2(np.minimum, k2[h], _u16x2(np.maximum, k1[h], key))
            k1[h] = _u16x2(np.minimum, k1[h], key)
    par = sg[0].copy()
    for g in sg[1:]:
        par ^= g
    par ^= par >> _U32(4)
    par ^= par >> _U32(2)
    par ^= par >> _U32(1)
    x = (sy ^ par ^ _U32(0x01010101 if D & 1 else 0)) & _U32(0x01010101)
    xm = x * _U32(0xFF)

    def lookup(mm):
        return sum(table[(mm >> _U32(8 * i)) & _U32(0xFF)].astype(_U32)
                   << _U32(8 * i) for i in range(4)).astype(_U32)

    def negate(s):
        if kind == "int8":
            return (_U32(0x80808080) - s) ^ _U32(0x80808080)
        return s | _U32(0x80808080)

    def pick(mask, a, b):
        return (a & mask) | (b & ~mask)

    pos = prmt(k1[0], k1[1], 0x6420)
    p1 = lookup(prmt(k1[0], k1[1], 0x7531))
    p2 = (np.full_like(p1, _U32(int(table[0]) * 0x01010101)) if D == 1
          else lookup(prmt(k2[0], k2[1], 0x7531)))
    n1, n2 = negate(p1), negate(p2)
    c1, d1 = pick(xm, n1, p1), pick(xm, p1, n1)
    c2, d2 = pick(xm, n2, p2), pick(xm, p2, n2)
    out = []
    for k in range(D):  # the write pass
        kk = _U32(0x01010101 * k)
        other = prmt((pos ^ kk) + _U32(0x7F7F7F7F), 0, 0xBA98)
        neg = prmt(sg[k // 8] << _U32(7 - k % 8), 0, 0xBA98)
        out.append(pick(other, pick(neg, d1, c1), pick(neg, d2, c2)))
    return np.stack(out).view(m.dtype).reshape(m.shape)
