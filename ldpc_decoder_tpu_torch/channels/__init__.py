"""Channel models: BSC, BI-AWGN and binary erasure."""

from ldpc_decoder_tpu_torch.channels.base import Channel
from ldpc_decoder_tpu_torch.channels.biawgn import BIAWGNChannel
from ldpc_decoder_tpu_torch.channels.bsc import BSCChannel
from ldpc_decoder_tpu_torch.channels.erasure import ErasureChannel


def make_channel(channel_idx: int, noise: float) -> Channel:
    """CLI channel selection: 0 = BSC, 1 = AWGN (main.cpp:228-246);
    2 = erasure (the reference's EXTRA_CHANNELS declaration,
    h/channel.h:112-133)."""
    if channel_idx == 0:
        return BSCChannel(noise)
    if channel_idx == 1:
        return BIAWGNChannel(noise)
    if channel_idx == 2:
        return ErasureChannel(noise)
    raise ValueError(f"unknown channel type {channel_idx}")


__all__ = ["Channel", "BIAWGNChannel", "BSCChannel", "ErasureChannel",
           "make_channel"]
