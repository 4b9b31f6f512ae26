"""Binary erasure channel.

The reference declares an ``erasure_channel`` behind a disabled build flag
(h/channel.h:112-133); the JAX package ships a working one, copied here.
Symbols are erased (channel value 0) with probability ε and received
intact otherwise; the decoder sees LLR 0 for erasures and a saturated LLR
for known bits, and BP then decodes by peeling. Capacity = 1 - ε.
"""

from __future__ import annotations

import numpy as np
import torch

from ldpc_decoder_tpu_torch.channels.base import Channel

# LLR magnitude of an unerased (known) bit; inside φ's clamp range
# (ops/phi.py), so φ stays a normal bfloat16
KNOWN_LLR = 40.0


class ErasureChannel(Channel):
    """BEC(ε): value 0 = erased, ±1 = known."""

    channel_type = "erasure"

    def __init__(self, epsilon: float):
        if not 0.0 < epsilon < 1.0:
            raise ValueError("erasure probability must be in (0, 1)")
        self.epsilon = float(epsilon)

    def add_noise_np(self, prng, values: np.ndarray) -> np.ndarray:
        # one unit() draw per sample, erase if < epsilon (the BSC pattern,
        # channel.cpp:34-38, with erasure instead of flip)
        erased = prng.units(values.shape[0]) < np.float32(self.epsilon)
        out = values.copy()
        out[erased] = 0.0
        return out

    def llr_from_channel(self, values: torch.Tensor) -> torch.Tensor:
        v = values.to(torch.float32)
        return torch.where(v == 0.0, 0.0, torch.sign(v) * KNOWN_LLR)

    def llr_np(self, values: np.ndarray) -> np.ndarray:
        v = values.astype(np.float32)
        return np.where(v == 0.0, np.float32(0.0),
                        np.sign(v) * np.float32(KNOWN_LLR))

    def capacity(self) -> float:
        return 1.0 - self.epsilon

    def description(self) -> str:
        return (f"Binary erasure channel with erasure probability: "
                f"{self.epsilon:g}")
