"""Decoder parameter structs.

Mirror of ``ldpc_decoder_tpu/runtime/params.py`` (the reference's
static/dynamic split, h/ldpc_decoder_gpu_common.h:7-54). The port runs
sum-product on float32 or bfloat16 messages; the options it does not run
yet raise ``NotImplementedError`` instead of being ignored.
"""

from __future__ import annotations

from dataclasses import dataclass

_MESSAGE_DTYPES = ("float32", "bfloat16")
_NOT_PORTED_DTYPES = ("float8_e5m2", "int8")


@dataclass
class StaticParams:
    """Fixed at decoder construction (h/ldpc_decoder_gpu_common.h:7-22)."""

    # log2 of the max number of frames resident on the device, user cap;
    # the memory model may lower it (h/ldpc_decoder_gpu_common.h:19)
    max_log_parallel_factor_user: int = 5
    # exact lane count (None = memory model chooses a power of two capped
    # by max_log_parallel_factor_user); bypasses the memory model
    parallel_factor_user: int | None = None
    # message storage dtype: "float32" or "bfloat16"
    message_dtype: str = "float32"
    # fraction of device memory kept free (ldpc_decoder_gpu.cu:84-88)
    memory_headroom: float = 0.10
    # device memory in bytes for the lane model (None = ask the card)
    device_memory_bytes: int | None = None
    # kernel family: only "auto" is ported (a regular base takes the
    # regular QC kernels, any other base the grouped ones)
    kernel_impl: str = "auto"
    # check-node rule: only "sum-product" is ported
    algorithm: str = "sum-product"

    def __post_init__(self):
        if self.parallel_factor_user is not None and self.parallel_factor_user <= 0:
            raise ValueError(
                f"parallel_factor_user must be positive, got "
                f"{self.parallel_factor_user}")
        if self.message_dtype in _NOT_PORTED_DTYPES:
            raise NotImplementedError(
                f"message_dtype={self.message_dtype!r} is not ported yet "
                f"(ported: {_MESSAGE_DTYPES})")
        if self.message_dtype not in _MESSAGE_DTYPES:
            raise ValueError(
                f"message_dtype must be one of {_MESSAGE_DTYPES}, "
                f"got {self.message_dtype!r}")
        if self.algorithm == "min-sum":
            raise NotImplementedError("algorithm='min-sum' is not ported yet")
        if self.algorithm != "sum-product":
            raise ValueError(f"unknown algorithm {self.algorithm!r}")
        if self.kernel_impl in ("pallas", "xla"):
            raise NotImplementedError(
                f"kernel_impl={self.kernel_impl!r} is not ported: the port "
                f"runs the QC kernels ('auto')")
        if self.kernel_impl != "auto":
            raise ValueError(f"unknown kernel_impl {self.kernel_impl!r}")


@dataclass
class DynamicParams:
    """Per-decode knobs (h/ldpc_decoder_gpu_common.h:24-54)."""

    # runtime LLR-magnitude cap t (φ-input floor φ(t) ≈ 2e^{-t},
    # flood_vec2.cl:187); None = the CUDA backend's 1e-5 (flood.cu:14)
    infinity_threshold: float | None = None
    # NB: a lane refilled by the lane-reset scheme spends its first
    # iteration on the in-kernel reset, counted in iters_done
    num_iter_max: int = 100
    # iterations between parity checks / refills
    num_iter_check_parity: int = 10
    # iteration of the FIRST parity check (0 = num_iter_check_parity): the
    # first (first_check - k) iterations run as a plain burst with no
    # hard-decision emit, parity check or retire/refill (initial
    # generation only; a frame converging during the burst retires at the
    # first check, so a too-large value costs time, never correctness)
    num_iter_first_check: int = 0
    # frames per run = parallel_factor * loading_factor (main.cpp:320)
    loading_factor: int = 4
