"""Decoder parameter structs.

Mirror of ``ldpc_decoder_tpu/runtime/params.py`` (the reference's
static/dynamic split, h/ldpc_decoder_gpu_common.h:7-54), with the same
fields, defaults and checks for what the port runs: sum-product on float32,
bfloat16 or float8_e5m2 messages, min-sum on float32, bfloat16,
float8_e5m2 or int8 messages. The options it does not run raise
``NotImplementedError`` instead of being ignored.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

_MESSAGE_DTYPES = ("float32", "bfloat16", "float8_e5m2", "int8")
_ALGORITHMS = ("sum-product", "min-sum")


@dataclass
class StaticParams:
    """Fixed at decoder construction (h/ldpc_decoder_gpu_common.h:7-22)."""

    # log2 of the max number of frames resident on the device, user cap;
    # the memory model may lower it (h/ldpc_decoder_gpu_common.h:19)
    max_log_parallel_factor_user: int = 5
    # exact lane count (None = memory model chooses a power of two capped
    # by max_log_parallel_factor_user); bypasses the memory model
    parallel_factor_user: int | None = None
    # message storage dtype: "float32", "bfloat16", "float8_e5m2" (QC codes
    # only; bfloat16 LLR state), or "int8" (fixed-point min-sum messages,
    # see minsum_qscale)
    message_dtype: str = "float32"
    # fraction of device memory kept free (ldpc_decoder_gpu.cu:84-88)
    memory_headroom: float = 0.10
    # device memory in bytes for the lane model (None = ask the card)
    device_memory_bytes: int | None = None
    # kernel family: only "auto" is ported (a QC code takes the regular or
    # grouped QC kernels, a code without QC structure the general kernels)
    kernel_impl: str = "auto"
    # recover undeclared circulant structure (aligned or block-interleaved
    # numbering) from plain alists, so they take the QC kernels; False
    # sends a code given without ``qc=`` to the general (any-alist) path
    qc_autodetect: bool = True
    # check-node rule: "sum-product" (the tanh rule in the φ domain,
    # flood.cu:88-114) or "min-sum" (normalized/offset two-minimum rule)
    algorithm: str = "sum-product"
    # offset β of offset-min-sum (|out| = max(α·min - β, 0))
    minsum_offset: float = 0.5
    # normalization α of normalized-min-sum: a float (uniform), or a
    # per-check-degree table {degree: α} / ((degree, α), ...); a 0 key is
    # the fallback for unlisted degrees (ops/qc_decode.resolve_minsum_alpha)
    minsum_alpha: float | tuple = 1.0
    # symmetric LLR clamp applied to min-sum variable messages
    minsum_clamp: float = 64.0
    # int8 fixed-point scale (steps per LLR unit) for message_dtype "int8":
    # messages are stored as round(m * qscale) saturated at ±127. A power
    # of two, so the dequantize multiply is exact in float32.
    minsum_qscale: float = 4.0

    def __post_init__(self):
        # per-degree alpha tables as a hashable tuple of (degree, α) pairs
        if isinstance(self.minsum_alpha, dict):
            self.minsum_alpha = tuple(sorted(
                (int(d), float(a)) for d, a in self.minsum_alpha.items()))
        elif isinstance(self.minsum_alpha, (list, tuple)):
            self.minsum_alpha = tuple(
                (int(d), float(a)) for d, a in self.minsum_alpha)
        if self.parallel_factor_user is not None and self.parallel_factor_user <= 0:
            raise ValueError(
                f"parallel_factor_user must be positive, got "
                f"{self.parallel_factor_user}")
        if self.message_dtype not in _MESSAGE_DTYPES:
            raise ValueError(
                f"message_dtype must be one of {_MESSAGE_DTYPES}, "
                f"got {self.message_dtype!r}")
        if self.algorithm not in _ALGORITHMS:
            raise ValueError(f"unknown algorithm {self.algorithm!r}")
        if self.message_dtype == "int8":
            if self.algorithm != "min-sum":
                raise ValueError(
                    "message_dtype='int8' is fixed-point min-sum storage; "
                    "it requires algorithm='min-sum' (the φ-domain "
                    "sum-product messages are not linearly quantizable)")
            if (self.minsum_qscale <= 0
                    or math.log2(self.minsum_qscale) % 1 != 0):
                raise ValueError(
                    f"minsum_qscale must be a positive power of two for "
                    f"exact dequantization, got {self.minsum_qscale}")
        if self.kernel_impl in ("pallas", "xla"):
            raise NotImplementedError(
                f"kernel_impl={self.kernel_impl!r} is not ported: the port "
                f"runs its own kernels ('auto')")
        if self.kernel_impl != "auto":
            raise ValueError(f"unknown kernel_impl {self.kernel_impl!r}")


@dataclass
class DynamicParams:
    """Per-decode knobs (h/ldpc_decoder_gpu_common.h:24-54)."""

    # runtime LLR-magnitude cap t (φ-input floor φ(t) ≈ 2e^{-t},
    # flood_vec2.cl:187); None = the CUDA backend's 1e-5 (flood.cu:14)
    infinity_threshold: float | None = None
    # NB: on the QC paths a lane refilled by the lane-reset scheme spends
    # its first iteration on the in-kernel reset, counted in iters_done
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
    # bit errors above which a frame counts as errored (the report's FER
    # line; main.cpp -e / -b)
    target_errors: int = 0
