"""Channel model interface.

Mirrors ``ldpc_decoder_tpu/channels/base.py`` with the decoder-side
conversion on torch tensors. LLR sign convention throughout: **LLR > 0 <=>
bit = 1** (h/common.h:51-59); modulation is bit 1 -> +1, bit 0 -> -1.

- ``add_noise_np``: numpy, consuming a seekable PRNG stream in exactly the
  reference's draw order (channel.cpp:29-37, 60-68).
- ``llr_from_channel``: raw channel values -> decoder-input LLRs on the
  tensor's own device (the llr_biawgn analog, flood.cu:47-75).
"""

from __future__ import annotations

import abc

import numpy as np
import torch


class Channel(abc.ABC):
    """A binary-input memoryless noisy channel."""

    #: CLI index (main.cpp:228-246): 0 = bsc, 1 = awgn
    channel_type: str

    @abc.abstractmethod
    def add_noise_np(self, prng, values: np.ndarray) -> np.ndarray:
        """Apply noise to ±1 modulated values, consuming ``prng`` draws in
        the reference's per-sample order. ``values`` is 1-D float32."""

    @abc.abstractmethod
    def llr_from_channel(self, values: torch.Tensor) -> torch.Tensor:
        """Convert raw channel output values to float32 LLRs."""

    @abc.abstractmethod
    def llr_np(self, values: np.ndarray) -> np.ndarray:
        """Numpy twin of :meth:`llr_from_channel` (channel.cpp:18-22,50-53)."""

    @abc.abstractmethod
    def capacity(self) -> float:
        """Shannon capacity in bits/symbol."""

    @abc.abstractmethod
    def description(self) -> str:
        ...
