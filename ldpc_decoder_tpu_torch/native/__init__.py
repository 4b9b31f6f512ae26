"""ctypes bindings for the port's native host library (``src/ldpc_host.cpp``).

The library implements the host-side hot path — seekable ChaCha8
keystream, reference-bit generation, channel noise (BI-AWGN and BSC),
bit-packed syndromes and the 32x32 bit transpose — natively (C++17 + OpenMP
+ AVX2 via ``-march=native``), mirroring the reference's AVX2 CPU layer
(chacha_stream.cpp, transpose.cpp, ldpc_code.cpp:256-286). The source is the
port's own copy of the JAX package's ``ldpc_decoder_tpu/native/src/
ldpc_host.cpp``, and the functions below keep that package's names and
signatures (``ldpc_decoder_tpu/native/__init__.py``).

The shared object is built with ``g++`` at first use into the port's
git-ignored build directory (``ldpc_decoder_tpu_torch/build/``) and bound
with ctypes (no pybind11; plain ``extern "C"``). ``available()`` is False
when ``g++`` cannot build the library; ``create_data(backend="auto")`` then
uses the numpy implementations, which give the same streams.
"""

from __future__ import annotations

import ctypes
import os
import sys
import threading

import numpy as np

from ldpc_decoder_tpu_torch._build import BuildError, build_shared_library

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src",
                      "ldpc_host.cpp")
_CMD = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-fopenmp",
        "-march=native"]

_lock = threading.Lock()
_lib = None
_build_error: str | None = None


def _load():
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        try:
            path = build_shared_library("ldpc_host", [SOURCE], _CMD,
                                        timeout=300)
        except (OSError, BuildError) as e:
            _build_error = f"build failed: {e}"
            print(f"ldpc_decoder_tpu_torch.native: {_build_error}",
                  file=sys.stderr)
            return None
        lib = ctypes.CDLL(path)
        u64, i64 = ctypes.c_uint64, ctypes.c_int64
        p_u32 = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
        p_i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        p_i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        p_f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        lib.ldpc_chacha_stream_words.argtypes = [u64, u64, u64, p_u32]
        lib.ldpc_gen_ref_words.argtypes = [u64, i64, i64, p_u32]
        lib.ldpc_add_noise_awgn.argtypes = [
            u64, i64, i64, i64, p_u32, ctypes.c_float, p_f32, i64]
        lib.ldpc_add_noise_bsc.argtypes = [
            u64, i64, i64, i64, p_u32, ctypes.c_float, p_f32, i64]
        lib.ldpc_compute_syndrome_words.argtypes = [
            p_i64, p_i32, i64, i64, p_u32, p_u32]
        lib.ldpc_deinterlace_words.argtypes = [p_u32, i64, i64, p_u32]
        for fn in (lib.ldpc_chacha_stream_words, lib.ldpc_gen_ref_words,
                   lib.ldpc_add_noise_awgn, lib.ldpc_add_noise_bsc,
                   lib.ldpc_compute_syndrome_words,
                   lib.ldpc_deinterlace_words):
            fn.restype = None
        lib.ldpc_native_version.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def stream_words(seed: int, start: int, count: int) -> np.ndarray:
    """Native twin of :func:`rng.chacha_np.stream_words` (word-exact)."""
    lib = _load()
    out = np.empty(count, dtype=np.uint32)
    lib.ldpc_chacha_stream_words(seed, start, count, out)
    return out


def gen_ref_words(start_index: int, n_vars: int, n_groups: int) -> np.ndarray:
    """[n_vars, n_groups] uint32 frame-interleaved reference bits
    (bit b of word [v, g] = bit v of frame 32g+b)."""
    lib = _load()
    out = np.empty((n_vars, n_groups), dtype=np.uint32)
    lib.ldpc_gen_ref_words(start_index, n_vars, n_groups, out.reshape(-1))
    return out


def add_noise(channel_type: str, param: float, vec_start: int,
              ref_words: np.ndarray, transmitted: int, n_frames: int,
              out: np.ndarray) -> None:
    """Fill ``out[:transmitted, :n_frames]`` (float32, C-contiguous rows of
    length out.shape[1]) with noisy channel values: ``"awgn"`` (``param`` =
    σ) or ``"bsc"`` (``param`` = p)."""
    lib = _load()
    fn = {"awgn": lib.ldpc_add_noise_awgn,
          "bsc": lib.ldpc_add_noise_bsc}[channel_type]
    n_vars, n_groups = ref_words.shape
    if out.dtype != np.float32 or not out.flags.c_contiguous:
        raise ValueError("out must be a C-contiguous float32 array")
    if out.shape[0] < transmitted or out.shape[1] < n_frames:
        raise ValueError(f"out {out.shape} too small for "
                         f"[{transmitted}, {n_frames}]")
    fn(vec_start, n_frames, transmitted, n_groups,
       np.ascontiguousarray(ref_words).reshape(-1), param, out.reshape(-1),
       out.shape[1])


def compute_syndrome_words(offsets: np.ndarray, indices: np.ndarray,
                           ref_words: np.ndarray) -> np.ndarray:
    """[n_checks, n_groups] uint32 interleaved syndromes via CSR XOR."""
    lib = _load()
    n_checks = offsets.shape[0] - 1
    n_groups = ref_words.shape[1]
    out = np.empty((n_checks, n_groups), dtype=np.uint32)
    lib.ldpc_compute_syndrome_words(
        np.ascontiguousarray(offsets, np.int64),
        np.ascontiguousarray(indices, np.int32),
        n_checks, n_groups, np.ascontiguousarray(ref_words).reshape(-1),
        out.reshape(-1))
    return out


def deinterlace_words(words: np.ndarray) -> np.ndarray:
    """Frame-interleaved [n_words, n_groups] -> per-frame packed
    [n_groups*32, ceil(n_words/32)] uint32 (deinterlace,
    main.cpp:273-299): each frame's n_words bits pack 32 per word."""
    lib = _load()
    n_words, n_groups = words.shape
    n_out_words = (n_words + 31) // 32
    out = np.empty((n_groups * 32, n_out_words), dtype=np.uint32)
    lib.ldpc_deinterlace_words(
        np.ascontiguousarray(words).reshape(-1), n_words, n_groups,
        out.reshape(-1))
    return out
