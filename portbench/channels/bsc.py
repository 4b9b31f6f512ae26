"""The binary symmetric channel at ``noise`` = p: a bit b is sent as
2b - 1 and its sign flipped with probability p; the LLR of a value y is
sign(y) log((1 - p) / p)."""

import math

import torch

# the program's channel, a class of ldpc_decoder_tpu_torch built with the
# noise
PROGRAM = "channels.BSCChannel"


def values(sent: torch.Tensor, noise: float, gen: torch.Generator):
    """The received values of the float32 ``sent`` [n_vars, F]."""
    flip = torch.rand(sent.shape, generator=gen, device=sent.device) < noise
    return torch.where(flip, -sent, sent)


def llr(values: torch.Tensor, noise: float) -> torch.Tensor:
    """float32 LLRs, bit 1 positive (0.0 stays 0.0: no information)."""
    return torch.sign(values.to(torch.float32)) * math.log(
        (1.0 - noise) / noise)
