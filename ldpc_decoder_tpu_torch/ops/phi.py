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
init and the tests use it; the CUDA kernels (csrc/qc_grouped.cu,
``phi_abs``) evaluate the same expression with the accurate ``tanhf`` /
``logf`` / ``expf`` (the build never uses fast math). φ is always
evaluated in float32, whatever dtype the messages are stored in.
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
