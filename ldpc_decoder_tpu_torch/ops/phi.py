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
float32, whatever dtype the messages are stored in.
"""

from __future__ import annotations

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
