"""Binary symmetric channel (reference: channel.cpp:6-38, 70-73)."""

from __future__ import annotations

import math

import numpy as np
import torch

from ldpc_decoder_tpu_torch.channels.base import Channel


class BSCChannel(Channel):
    """Flips each ±1 symbol with probability p; LLR = ±log((1-p)/p)."""

    channel_type = "bsc"

    def __init__(self, p: float):
        if not 0.0 < p < 0.5:
            raise ValueError("BSC error probability must be in (0, 0.5)")
        self.p = float(p)
        # channel.cpp:8 — log(1-p) - log(p)
        self.llr_ref = math.log(1.0 - self.p) - math.log(self.p)

    def add_noise_np(self, prng, values: np.ndarray) -> np.ndarray:
        # channel.cpp:34-38 — one unit() draw per sample, flip if < p
        flips = prng.units(values.shape[0]) < np.float32(self.p)
        out = values.copy()
        out[flips] = -out[flips]
        return out

    def llr_from_channel(self, values: torch.Tensor) -> torch.Tensor:
        # flood.cu:47-60 — copysign(llr_ref, value); the sign of ±0 is kept
        v = values.to(torch.float32)
        return torch.full_like(v, float(np.float32(self.llr_ref))).copysign(v)

    def llr_np(self, values: np.ndarray) -> np.ndarray:
        return np.copysign(np.float32(self.llr_ref),
                           values.astype(np.float32))

    def capacity(self) -> float:
        # channel.cpp:70-73
        p = self.p
        return 1.0 + p * math.log2(p) + (1.0 - p) * math.log2(1.0 - p)

    def description(self) -> str:
        # test_report wording (channel.cpp:24-27)
        return f"Binary channel with bit error probability: {self.p:g}"
