"""Channel models (BI-AWGN so far)."""

from ldpc_decoder_tpu_torch.channels.base import Channel
from ldpc_decoder_tpu_torch.channels.biawgn import BIAWGNChannel

__all__ = ["Channel", "BIAWGNChannel"]
