"""Binary-input AWGN channel (reference: channel.cpp:40-68, 75-101)."""

from __future__ import annotations

import math

import numpy as np
import torch

from ldpc_decoder_tpu_torch.channels.base import Channel


def _log_cosh(x: np.ndarray, rng: float) -> np.ndarray:
    # channel.cpp:75-81 — |x| - log 2 approximation outside [-range, range]
    ax = np.abs(x)
    return np.where(ax > rng, ax - math.log(2.0), np.log(np.cosh(x)))


def biawgn_capacity(s: float, step: float = 0.05, rng: float = 16.0) -> float:
    """Numeric capacity integral, same quadrature as channel.cpp:83-101."""
    if s < 1e-3:
        return 1.0
    inv_s = 1.0 / s
    sq_inv_s = inv_s * inv_s
    xs = np.arange(-rng, rng, step, dtype=np.float64)
    vals = np.exp(-xs * xs / 2.0) * (sq_inv_s - _log_cosh(xs * inv_s + sq_inv_s, rng))
    return float(vals.sum() * step / (math.log(2.0) * math.sqrt(2.0 * math.pi)))


class BIAWGNChannel(Channel):
    """±1 symbols + N(0, σ²) noise; LLR = 2·value/σ²."""

    channel_type = "awgn"

    def __init__(self, sigma: float):
        if sigma <= 0:
            raise ValueError("noise standard deviation must be positive")
        self.sigma = float(sigma)
        self.snr = 1.0 / (self.sigma * self.sigma)  # channel.cpp:42
        self.factor = 2.0 * self.snr  # h/channel.h:70-73

    def add_noise_np(self, prng, values: np.ndarray) -> np.ndarray:
        # channel.cpp:65-68 — one gaussian() per sample (polar Box–Muller)
        g = prng.gaussians(values.shape[0])
        return (values.astype(np.float32)
                + g.astype(np.float32) * np.float32(self.sigma))

    def llr_from_channel(self, values: torch.Tensor) -> torch.Tensor:
        # flood.cu:62-75 — multiply by 2/σ², in float32 like the JAX
        # package: the factor is rounded to float32 first, so the product
        # is the correctly rounded float32 one whatever precision torch
        # computes a scalar product in
        return values.to(torch.float32) * float(np.float32(self.factor))

    def llr_np(self, values: np.ndarray) -> np.ndarray:
        return values.astype(np.float32) * np.float32(self.factor)

    def capacity(self) -> float:
        return biawgn_capacity(self.sigma)

    def description(self) -> str:
        return (
            f"Binary channel with Gaussian noise of std. deviation "
            f"{self.sigma:g}; SNR = {self.snr:g}"
        )
