"""Channel models: BSC, BI-AWGN and binary erasure."""

from ldpc_decoder_tpu_torch.channels.base import Channel
from ldpc_decoder_tpu_torch.channels.biawgn import BIAWGNChannel
from ldpc_decoder_tpu_torch.channels.bsc import BSCChannel
from ldpc_decoder_tpu_torch.channels.erasure import ErasureChannel

__all__ = ["Channel", "BIAWGNChannel", "BSCChannel", "ErasureChannel"]
