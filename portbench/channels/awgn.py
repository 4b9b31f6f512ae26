"""BI-AWGN at ``noise`` = sigma: a bit b is sent as 2b - 1 and
N(0, sigma^2) noise added; the LLR of a value y is 2y / sigma^2."""

import torch

# the program's channel, a class of ldpc_decoder_tpu_torch built with the
# noise
PROGRAM = "channels.BIAWGNChannel"


def values(sent: torch.Tensor, noise: float, gen: torch.Generator):
    """The received values of the float32 ``sent`` [n_vars, F]."""
    out = torch.randn(sent.shape, generator=gen, device=sent.device)
    return out.mul_(noise).add_(sent)


def llr(values: torch.Tensor, noise: float) -> torch.Tensor:
    """float32 LLRs, bit 1 positive (0.0 stays 0.0: no information)."""
    return values.to(torch.float32) * (2.0 / (noise * noise))
