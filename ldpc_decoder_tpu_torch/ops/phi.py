"""The φ function of sum-product LDPC decoding, on torch tensors.

φ_abs(x) = -log(tanh(x/2)) on R+, which is self-inverse; φ(x) applies it to
|x| and carries the sign. Inputs are clamped to [pre, high] (pre = 1e-5
bounds the output at ≈ 12.2; high = 80 keeps φ a normal bfloat16, so a
saturated message never loses its sign) and the tail ``2·e^{-x}`` is used
for x > 5 (flood.cu:31-45; ``ldpc_decoder_tpu/ops/phi.py``). The regular QC
family clamps at 10 for float8_e5m2 messages (:func:`phi_high`), the JAX
regular kernels' ``PHI_HIGH_BY_DTYPE``; the grouped family keeps 80 for
every dtype, as its JAX kernels do.

This is the port's one φ formula in Python: the plain passes, the message
init and the tests use it; the CUDA kernels (csrc/common.cuh ``phi_abs``)
evaluate the same expression with the accurate ``tanhf`` / ``logf`` /
``expf`` (the build never uses fast math). The QC sum-product kernels of
both families evaluate it instead from the card's MUFU operations and FMAs
(csrc/sum_product.cuh ``phi_abs_fast``); :func:`phi_abs_fast_np` is that
function's float32 model, step for step, with the constants fitted by
:mod:`ldpc_decoder_tpu_torch.ops.phi_fit`. φ is always evaluated in
float32, whatever dtype the messages are stored in, except by the general
path's float8_e5m2 kernels (csrc/general_e5m2.cuh), which map the clamped
float32 input straight to its float8_e5m2 code through a table of
thresholds (:func:`phi_e5m2_thresholds`, :func:`phi_e5m2_table`): φ
correctly rounded to e5m2, whose plain version is :func:`phi_e5m2` and
whose lookup :func:`phi_e5m2_lookup_np` models step for step.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

PRE_THRESHOLD = 1e-5  # flood.cu:14
TAYLOR_LIMIT = 5.0  # flood.cu:32
HIGH_THRESHOLD = 80.0
# φ-input clamp of the regular QC family per message dtype
# (ldpc_decoder_tpu/ops/qc_pallas.py:77-84): φ(10) = 9.1e-5 stays a normal
# e5m2 (min normal 6.1e-5), the reference's infinity threshold of 10
PHI_HIGH_BY_DTYPE = {torch.float8_e5m2: 10.0}


def phi_high(dtype: torch.dtype) -> float:
    """The regular family's φ-input clamp for messages stored in ``dtype``."""
    return PHI_HIGH_BY_DTYPE.get(dtype, HIGH_THRESHOLD)


def pre_from_infinity_threshold(t: float | None) -> float:
    """φ-input floor realizing a runtime infinity threshold t:
    φ(t+1) ≈ 2e^{-(t+1)} caps message magnitudes at t + 1
    (flood_vec2.cl:72-74, 187); ``None`` selects the CUDA backend's
    hard-coded 1e-5 (flood.cu:14)."""
    if t is None:
        return PRE_THRESHOLD
    return 2.0 * math.exp(-(float(t) + 1.0))


def phi_abs(x: torch.Tensor, pre: float = PRE_THRESHOLD,
            high: float = HIGH_THRESHOLD) -> torch.Tensor:
    """φ_abs = -log(tanh(x/2)) for x >= 0, float32, clamped to
    [pre, high]."""
    xm = x.to(torch.float32).clamp(min=pre, max=high)
    main = -torch.log(torch.tanh(xm * 0.5))
    return torch.where(xm > TAYLOR_LIMIT, 2.0 * torch.exp(-xm), main)


def phi(x: torch.Tensor, pre: float = PRE_THRESHOLD,
        high: float = HIGH_THRESHOLD) -> torch.Tensor:
    """Signed φ: phi_abs(|x|) with the sign of x, ±0 included
    (flood.cu:40-45)."""
    x32 = x.to(torch.float32)
    return torch.copysign(phi_abs(x32.abs(), pre, high), x32)


def phi_abs_np(x, pre: float = PRE_THRESHOLD, high: float = HIGH_THRESHOLD):
    """Numpy float64 reference implementation (for tests and checks)."""
    x = np.asarray(x, dtype=np.float64)
    xm = np.clip(x, pre, high)
    main = -np.log(np.tanh(xm * 0.5))
    return np.where(xm > TAYLOR_LIMIT, 2.0 * np.exp(-xm), main)


# ---- the QC kernels' fast φ (csrc/sum_product.cuh phi_abs_fast) -----------

# x below: -ln(x) + h(x²); from it up: t·P(t²), t = e^{-x}; above 5: 2t
PHI_FAST_SPLIT = 1.0
LOG2E_HI = float.fromhex("0x1.715476p+0")    # float32(log2 e)
LOG2E_LO = float.fromhex("0x1.4ae0c0p-26")   # log2 e − LOG2E_HI
LN2_F32 = float.fromhex("0x1.62e430p-1")
# float32 coefficients, lowest degree first (ops/phi_fit.py reproduces them)
PHI_FAST_SMALL = tuple(float.fromhex(h) for h in (
    "0x1.62e440p-1", "0x1.554c96p-4", "-0x1.3c5488p-8", "0x1.314002p-12"))
PHI_FAST_MID = tuple(float.fromhex(h) for h in (
    "0x1.fffff4p+0", "0x1.556c8cp-1", "0x1.93180ap-2", "0x1.6d616cp-2"))
# the fast φ's target: max relative error against float64 (the accurate
# tanhf/logf/expf kernel measured 2.43e-6 on an H100)
PHI_FAST_MAX_REL_ERR = 2.5e-6


def _fma(a, b, c):
    """float32 a·b + c with one rounding (a·b is exact in float64; the
    double rounding of the float64 sum is below what the tests resolve)."""
    f64 = np.float64
    return (f64(a) * f64(b) + f64(c)).astype(np.float32)


def _horner(coef, u):
    p = _fma(np.float32(coef[3]), u, np.float32(coef[2]))
    p = _fma(p, u, np.float32(coef[1]))
    return _fma(p, u, np.float32(coef[0]))


def phi_abs_fast_np(x, pre: float = PRE_THRESHOLD,
                    high: float = HIGH_THRESHOLD) -> np.ndarray:
    """Float32 model of the QC kernels' ``phi_abs_fast``: the same
    operations in the same order, each rounded to float32, with the card's
    ``ex2.approx`` and ``lg2.approx`` modelled as correctly rounded. The
    input floor is max(pre, the least normal float32), as the kernel's
    flush-to-zero lg2 needs."""
    f32 = np.float32
    x = np.asarray(x, dtype=f32)
    lo = max(f32(pre), np.finfo(f32).tiny)
    xm = np.minimum(np.maximum(x, lo), f32(high))
    y = xm * f32(LOG2E_HI)
    r = _fma(xm, f32(LOG2E_HI), -y)
    r = _fma(xm, f32(LOG2E_LO), r)
    e = np.exp2(-y.astype(np.float64)).astype(f32)
    p = _horner(PHI_FAST_MID, e * e)
    p = np.where(xm > f32(TAYLOR_LIMIT), f32(2.0), p)
    mid = (e * p) * _fma(r, -f32(LN2_F32), f32(1.0))
    h = _horner(PHI_FAST_SMALL, xm * xm)
    small = _fma(np.log2(xm.astype(np.float64)).astype(f32), -f32(LN2_F32),
                 h)
    return np.where(xm < f32(PHI_FAST_SPLIT), small, mid).astype(f32)


# ---- φ rounded to float8_e5m2 by thresholds (csrc/general_e5m2.cuh) ---------
#
# φ_abs is decreasing, so round_e5m2(φ_abs(x)) is a step function of x: it
# steps down one code where φ_abs crosses the midpoint m_j between the
# positive e5m2 values of codes j and j + 1, at t_j = min{x : φ_abs(x) <=
# m_j}. For x in [FLT_MIN, 80] the code is #{j : x < t_j}: 86 thresholds,
# from t_0 = 12.48 (above it every φ rounds to 0) down to t_85 = 1.2e-38
# (φ(FLT_MIN) = 88.03 rounds to 96, code 86).

E5M2_FINE_SHIFT = 17  # 64 buckets a binade: float32 bits >> 17
E5M2_FINE_EXP = 123   # biased exponent of 2^-4, where the fine buckets start
# the coarse buckets (one a binade, below 2^-4) sit just under the fine
# ones: bucket = max(bits >> 17, (bits >> 23) + E5M2_COARSE_OFFSET)
E5M2_COARSE_OFFSET = 63 * E5M2_FINE_EXP
E5M2_FIRST_BUCKET = 1 + E5M2_COARSE_OFFSET  # the binade of FLT_MIN
_FLT_MIN = float(np.finfo(np.float32).tiny)


def _phi_abs_f64(x: float) -> float:
    """The reference φ_abs in float64, with its tail past TAYLOR_LIMIT."""
    if x > TAYLOR_LIMIT:
        return 2.0 * math.exp(-x)
    return -math.log(math.tanh(0.5 * x))


def _e5m2_values() -> np.ndarray:
    """The positive finite float8_e5m2 values, by code (0 .. 0x7B)."""
    codes = torch.arange(0x7C, dtype=torch.uint8)
    return codes.view(torch.float8_e5m2).double().numpy()


@functools.lru_cache(maxsize=None)
def phi_e5m2_thresholds() -> tuple[np.ndarray, np.ndarray]:
    """(t64, t32): the thresholds t_j in float64 and rounded up to float32,
    both decreasing, for the midpoints φ_abs crosses on [FLT_MIN, 80].
    t64[j] is the least float64 x with φ_abs(x) <= m_j (a bisection over
    the float64 bit patterns of the piecewise reference, monotone across
    its seam at 5); t32[j] the least float32 >= t64[j], so that for every
    float32 x, x < t32[j] exactly when φ_abs(x) > m_j."""
    vals = _e5m2_values()
    mids = 0.5 * (vals[:-1] + vals[1:])
    lo_phi, hi_phi = _phi_abs_f64(HIGH_THRESHOLD), _phi_abs_f64(_FLT_MIN)

    def bits(x):
        return int(np.float64(x).view(np.int64))

    def value(b):
        return float(np.int64(b).view(np.float64))

    t64 = []
    for m in mids[(mids > lo_phi) & (mids < hi_phi)]:
        lo, hi = bits(_FLT_MIN), bits(HIGH_THRESHOLD)  # φ(lo) > m >= φ(hi)
        while hi - lo > 1:
            mid = (lo + hi) // 2
            if _phi_abs_f64(value(mid)) > m:
                lo = mid
            else:
                hi = mid
        t64.append(value(hi))
    t64 = np.array(t64)
    t32 = t64.astype(np.float32)
    t32 = np.where(t32.astype(np.float64) < t64,
                   np.nextafter(t32, np.float32(np.inf)), t32)
    t64.flags.writeable = False
    t32.flags.writeable = False
    return t64, t32


def phi_e5m2_zero() -> float:
    """t32[0], the kernels' upper clamp: every x >= it has code 0."""
    return float(phi_e5m2_thresholds()[1][0])


def phi_e5m2_bucket_np(bits) -> np.ndarray:
    """The kernels' bucket of a positive float32 given by its bits (uint32):
    max(bits >> 17, (bits >> 23) + E5M2_COARSE_OFFSET) - E5M2_FIRST_BUCKET,
    64 a binade from 2^-4 up, one a binade below."""
    b = np.asarray(bits, dtype=np.int64)
    return (np.maximum(b >> E5M2_FINE_SHIFT, (b >> 23) + E5M2_COARSE_OFFSET)
            - E5M2_FIRST_BUCKET)


def phi_e5m2_bucket_bounds() -> tuple[np.ndarray, np.ndarray]:
    """(first, last): the float32 bits (int64) of the least and the largest
    x of each bucket within [FLT_MIN, t32[0]]."""
    top = int(np.float32(phi_e5m2_zero()).view(np.uint32))
    floor = int(np.float32(_FLT_MIN).view(np.uint32))
    k = np.arange(int(phi_e5m2_bucket_np(top)) + 1, dtype=np.int64) \
        + E5M2_FIRST_BUCKET
    coarse = k < (E5M2_FINE_EXP << (23 - E5M2_FINE_SHIFT))
    exp = k - E5M2_COARSE_OFFSET
    first = np.where(coarse, exp << 23, k << E5M2_FINE_SHIFT)
    last = np.where(coarse, ((exp + 1) << 23) - 1,
                    ((k + 1) << E5M2_FINE_SHIFT) - 1)
    return np.maximum(first, floor), np.minimum(last, top)


@functools.lru_cache(maxsize=None)
def phi_e5m2_table() -> np.ndarray:
    """[N] uint32, one word a bucket of float32 x in [FLT_MIN, t32[0]]: c,
    the code of the bucket's largest x, in the low byte, and above it the
    bits of its threshold t32[c] shifted left by 8 (cut to 32 bits), or of
    the bucket's binade's least float where t32[c] lies below that binade
    (or c is the last code). Every bucket holds at most one threshold and
    lies in one binade, so for each of its x, code(x) = c + (x < t32[c]);
    and with xq = (bits(x) << 8) | 0xFF, which shares the word's top bit
    (the exponent's lowest), x < t32[c] exactly when xq − word is
    negative as an int32 (the tests hold the lookup to the thresholds on
    the first and last x of every bucket)."""
    t32 = phi_e5m2_thresholds()[1]
    first, last = phi_e5m2_bucket_bounds()
    rows = np.arange(len(first))
    assert np.array_equal(phi_e5m2_bucket_np(first), rows)
    assert np.array_equal(phi_e5m2_bucket_np(last), rows)

    def code(b):
        x = torch.from_numpy(b.astype(np.uint32).view(np.float32))
        return phi_e5m2_codes(x, 0.0).numpy().astype(np.int64)

    c = code(last)
    assert (code(first) - c <= 1).all(), "a bucket holds two thresholds"
    thr = t32[np.minimum(c, len(t32) - 1)].view(np.uint32).astype(np.int64)
    binade = first >> 23
    inside = (c < len(t32)) & ((thr >> 23) == binade)
    bits = np.where(inside, thr, binade << 23)
    table = (((bits << 8) & 0xFFFFFFFF) | c).astype(np.uint32)
    table.flags.writeable = False
    return table


def _e5m2_floor(pre: float) -> np.float32:
    return max(np.float32(pre), np.float32(_FLT_MIN))


def phi_e5m2_lookup_np(x, pre: float = PRE_THRESHOLD) -> np.ndarray:
    """Model of the kernels' lookup, step for step: x (float32, >= 0 or
    NaN) clamped to [max(pre, FLT_MIN), t32[0]] as fmaxf/fminf clamp (a NaN
    takes the floor), its bucket's word w, xq = (bits << 8) | 0xFF, the code
    (w & 0xFF) + ((xq − w) >> 31) in uint32 arithmetic. Returns the codes
    (uint8)."""
    x = np.asarray(x, dtype=np.float32)
    xm = np.fmin(np.fmax(x, _e5m2_floor(pre)), np.float32(phi_e5m2_zero()))
    bits = xm.view(np.uint32).astype(np.int64)
    w = phi_e5m2_table()[phi_e5m2_bucket_np(bits)].astype(np.int64)
    xq = ((bits << 8) & 0xFFFFFFFF) | 0xFF
    return ((w & 0xFF) + (((xq - w) & 0xFFFFFFFF) >> 31)).astype(np.uint8)


def phi_e5m2_codes(x: torch.Tensor, pre: float = PRE_THRESHOLD
                   ) -> torch.Tensor:
    """Plain version of the kernels' lookup: the e5m2 code (uint8, no
    sign) of φ_abs(x) correctly rounded, x (float32, >= 0 or NaN) clamped
    to [max(pre, FLT_MIN), 80] as the kernels clamp it (fmax, fmin: a NaN
    takes the floor), through ``torch.bucketize`` on the thresholds."""
    t32 = phi_e5m2_thresholds()[1]
    asc = torch.from_numpy(t32[::-1].copy()).to(x.device)
    lo = torch.tensor(float(_e5m2_floor(pre)), device=x.device)
    hi = torch.tensor(HIGH_THRESHOLD, device=x.device)
    xm = torch.fmin(torch.fmax(x.to(torch.float32), lo), hi)
    return (len(t32) - torch.bucketize(xm, asc, right=True)).to(torch.uint8)


def phi_e5m2(x: torch.Tensor, pre: float = PRE_THRESHOLD) -> torch.Tensor:
    """Signed φ correctly rounded to float8_e5m2: the code of φ_abs(|x|)
    with the sign bit of x (±0 kept), as float8_e5m2."""
    x32 = x.to(torch.float32)
    code = phi_e5m2_codes(x32.abs(), pre)
    sign = torch.signbit(x32).to(torch.uint8) << 7
    return (code | sign).view(torch.float8_e5m2)
