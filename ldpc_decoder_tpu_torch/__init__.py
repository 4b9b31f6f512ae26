"""ldpc_decoder_tpu_torch — the LDPC soft decoder in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The port of ``ldpc_decoder_tpu`` (JAX/Pallas on a TPU), which stays beside
it as the reference: module paths mirror the JAX package's, so each
counterpart is found under the same name. This package imports torch and
never jax. Batched syndrome-based flood belief propagation on QC-LDPC codes
of ~10^6 bits, frames on the last (lane) axis of every device array, with
on-the-fly retire and refill of converged frames.
"""

__version__ = "0.1.0"

from ldpc_decoder_tpu_torch.channels import BIAWGNChannel, BSCChannel, Channel
from ldpc_decoder_tpu_torch.codes.alist import parse_alist, write_alist
from ldpc_decoder_tpu_torch.codes.code import LDPCCode, compute_syndrome, rate

__all__ = [
    "LDPCCode",
    "compute_syndrome",
    "rate",
    "parse_alist",
    "write_alist",
    "Channel",
    "BSCChannel",
    "BIAWGNChannel",
    "__version__",
]
