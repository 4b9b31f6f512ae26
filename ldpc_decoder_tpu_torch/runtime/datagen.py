"""Test-vector generation on the host (the reference's create_data,
main.cpp:450-538).

JAX-free copy of ``ldpc_decoder_tpu/runtime/datagen.py``, held equal to it
by ``tests/test_torch_host.py``: reference random bits, noisy channel
values and syndromes, with the reference's seeding so any frame is
reproducible from its absolute index alone (main.cpp:474-481):

- reference bits: the group of frames [32g, 32g+32) uses the stream seeded
  ``start + 32*g``, whose j-th word supplies bit j of all 32 frames;
- noisy values: frame v uses the stream seeded ``(start + v) | 2^32``, one
  channel draw per transmitted bit; erased (punctured) trailing variables
  get channel value 0 (main.cpp:529-530).

Backends: pure numpy, or the port's native C++ library
(:mod:`ldpc_decoder_tpu_torch.native`, BI-AWGN and BSC) when ``g++`` builds
it — same streams, several times faster.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ldpc_decoder_tpu_torch.channels.base import Channel
from ldpc_decoder_tpu_torch.codes.code import LDPCCode, compute_syndrome
from ldpc_decoder_tpu_torch.rng.chacha_np import PrngChacha, stream_words

NOISE_SEED_FLAG = 1 << 32  # main.cpp:522


@dataclass
class FrameBatch:
    """One batch of generated frames (frames on the trailing axis)."""

    ref_bits: np.ndarray   # [n_vars, N] int8
    values: np.ndarray     # [n_vars, N] float32 noisy channel values
    syndromes: np.ndarray  # [n_checks, N] int8

    def ref_bits_packed(self) -> np.ndarray:
        """[N, ceil(n_vars/32)] uint32, natural per-frame layout."""
        n_vars, n = self.ref_bits.shape
        n_words = (n_vars + 31) // 32
        bits = self.ref_bits.astype(np.uint32)
        if n_words * 32 != n_vars:
            bits = np.concatenate(
                [bits, np.zeros((n_words * 32 - n_vars, n), np.uint32)]
            )
        shifts = np.arange(32, dtype=np.uint32)[None, :, None]
        return (bits.reshape(n_words, 32, n) << shifts).sum(
            axis=1, dtype=np.uint32
        ).T


def generate_reference_bits(
    n_vars: int, start_index: int, n_frames: int
) -> np.ndarray:
    """[n_vars, n_frames] int8, reference-stream exact (main.cpp:478-487)."""
    n_groups = (n_frames + 31) // 32
    out = np.empty((n_vars, n_groups * 32), dtype=np.int8)
    for g in range(n_groups):
        words = stream_words(start_index + 32 * g, 0, n_vars)  # [n_vars]
        bits = (
            words[:, None] >> np.arange(32, dtype=np.uint32)[None, :]
        ) & np.uint32(1)
        out[:, 32 * g : 32 * g + 32] = bits.astype(np.int8)
    return out[:, :n_frames]


def create_data(
    code: LDPCCode,
    channel: Channel,
    start_index: int,
    n_frames: int,
    batch_index: int = 0,
    backend: str = "auto",
) -> FrameBatch:
    """Generate one decode batch, reference-stream exact.

    ``backend``: "native" (C++ library; BI-AWGN and BSC), "numpy", or
    "auto" (native when the library builds and the channel is BI-AWGN or
    BSC, numpy otherwise, as in the JAX package). Both produce the same
    streams; BI-AWGN values may differ in the last ulp (libm vs numpy
    transcendentals), BSC values are equal.
    """
    vec_start = start_index + batch_index * n_frames
    transmitted = code.n_vars - code.n_erased_vars

    if backend == "auto":
        from ldpc_decoder_tpu_torch import native

        backend = "native" if (
            channel.channel_type in ("awgn", "bsc") and native.available()
        ) else "numpy"

    if backend == "native":
        return _create_data_native(code, channel, vec_start, n_frames,
                                   transmitted)
    if backend != "numpy":
        raise ValueError(f"unknown backend {backend!r}")

    ref_bits = generate_reference_bits(code.n_vars, vec_start, n_frames)
    values = np.zeros((code.n_vars, n_frames), dtype=np.float32)
    prng = PrngChacha(0)
    tx_all = np.where(ref_bits[:transmitted] > 0, 1.0, -1.0).astype(
        np.float32
    )  # bool_to_llr (h/common.h:56-59)
    for v in range(n_frames):
        prng.reset_seed((vec_start + v) | NOISE_SEED_FLAG)
        values[:transmitted, v] = channel.add_noise_np(prng, tx_all[:, v])

    syndromes = compute_syndrome(code, ref_bits)
    return FrameBatch(ref_bits=ref_bits, values=values, syndromes=syndromes)


def _create_data_native(code: LDPCCode, channel: Channel, vec_start: int,
                        n_frames: int, transmitted: int) -> FrameBatch:
    """Native (C++/OpenMP) create_data: same streams, parallel over frames."""
    from ldpc_decoder_tpu_torch import native

    if channel.channel_type not in ("awgn", "bsc"):
        raise ValueError(
            f"native datagen supports awgn/bsc channels only, got "
            f"{channel.channel_type!r}; use backend='numpy' or 'auto'"
        )
    if not native.available():
        raise RuntimeError("the native library did not build (see stderr)")
    n_groups = (n_frames + 31) // 32
    ref_words = native.gen_ref_words(vec_start, code.n_vars, n_groups)

    values = np.zeros((code.n_vars, n_frames), dtype=np.float32)
    param = channel.sigma if channel.channel_type == "awgn" else channel.p
    native.add_noise(channel.channel_type, param, vec_start, ref_words,
                     transmitted, n_frames, values)

    syn_words = native.compute_syndrome_words(
        code.out_bit_to_edge.astype(np.int64), code.out_edge_to_in_bit,
        ref_words)

    shifts = np.arange(32, dtype=np.uint32)
    ref_bits = (
        (ref_words[:, :, None] >> shifts[None, None]) & np.uint32(1)
    ).astype(np.int8).reshape(code.n_vars, n_groups * 32)[:, :n_frames]
    syndromes = (
        (syn_words[:, :, None] >> shifts[None, None]) & np.uint32(1)
    ).astype(np.int8).reshape(code.n_checks, n_groups * 32)[:, :n_frames]
    return FrameBatch(ref_bits=ref_bits, values=values, syndromes=syndromes)
