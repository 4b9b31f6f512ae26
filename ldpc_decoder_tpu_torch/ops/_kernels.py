"""Build, load and launch the CUDA kernels of ``csrc/``.

Seven libraries: ``qc_grouped`` (the grouped family's sum-product and
parity kernels, one launch per degree group; ``qc_grouped.cu``,
``qc_grouped_accurate.cu`` and ``qc_grouped_parity.cu``, which compile in
parallel, and the kernels' header ``qc_grouped.cuh``), ``qc_regular`` (the
regular family's, one launch per pass; ``qc_regular.cu``,
``qc_regular_accurate.cu`` and ``qc_regular_parity.cu`` in parallel, the
kernels in ``qc_regular.cuh``), ``qc_minsum`` (the
min-sum check and variable kernels of both QC families, int8 messages in
the grouped one: ``qc_minsum.cu`` and, in parallel, ``qc_minsum_cn.cu``,
the grouped check kernel), ``general`` (the general any-alist path, one
launch per degree bucket: ``general.cu``, the sum-product dispatch and
the min-sum variable one, ``general_accurate.cu``, ``general_minsum.cu``,
the min-sum check dispatch, and ``general_fp8.cu``, every float8_e5m2
instantiation, in parallel, the sum-product kernels in ``general.cuh``,
the float8_e5m2 ones that the decoder launches in ``general_e5m2.cuh``
(φ and the store as one threshold lookup, on a table built by
:func:`~ldpc_decoder_tpu_torch.ops.phi.phi_e5m2_table` and kept on each
device by :func:`phi_e5m2_table`), the min-sum ones in
``general_minsum.cuh``) and
``probes.cu`` (the measurement probes of
:mod:`ldpc_decoder_tpu_torch.probes`, which no decode runs) and
``datagen.cu`` (a frame pool's ChaCha8 reference bits and channel values,
:mod:`ldpc_decoder_tpu_torch.rng.chacha_torch`) and ``retire.cu`` (the
superstep's retire: the finished lanes' hard bits packed into the results,
:mod:`ldpc_decoder_tpu_torch.ops.retire`). The
sum-product check and variable kernels of all three families share
``sum_product.cuh``: the fast φ, the φ policies and the vectors of lanes;
the grouped and general min-sum check kernels share ``minsum.cuh``, the
check row on those vectors; the two QC parity kernels are one template in
``parity.cuh``; all sources include ``common.cuh``. Each is
compiled by ``nvcc`` for ``sm_90a`` into a library with a plain ``extern "C"``
interface (no PyTorch headers, so it builds in seconds) at first use, into
the git-ignored ``ldpc_decoder_tpu_torch/build/``; a changed source or
header rebuilds. Fast math is never enabled: φ's accuracy near x = 5
carries the decoder.

Each launch function below launches one kernel on the current torch
stream and adds one to its entry of :data:`launch_counts` (the port's only
global state), so a run can show that its main path went through the
kernels. The sum-product kernels count their float8_e5m2 launches apart
(``cn_fp8``, ``vn_fp8``, ``cn_regular_fp8``, ``vn_regular_fp8``,
``cn_general_fp8``, ``vn_general_fp8``), since those are the float8
branches of other TPU kernels' rows, and so do the general min-sum kernels
(``cn_general_minsum_fp8``, ``vn_general_minsum_fp8``: the general path's
float8 decode has no other kernel); the QC min-sum kernels count every
message dtype under one name, and the two
min-sum check kernels and the two parity kernels count their vector
launches again under ``cn_group_minsum_vec``, ``cn_general_minsum_vec``,
``parity_vec`` and ``parity_regular_vec``, so a run shows which
instantiation it took; the probes count ``probe_row_copy`` and
``probe_window``, the pool generators ``chacha_bits`` and
``channel_values`` (its four-frame vector launches again under
``channel_values_vec``), the retire ``retire_pack`` (one launch per
superstep that retires a lane). Every sum-product launch of the accurate
φ also counts under ``phi_accurate``, which no decode touches. Argument
checking is the callers' job (:mod:`ldpc_decoder_tpu_torch.ops.qc_grouped`,
:mod:`ldpc_decoder_tpu_torch.ops.qc_regular`,
:mod:`ldpc_decoder_tpu_torch.ops.general`,
:mod:`ldpc_decoder_tpu_torch.probes.kernels`,
:mod:`ldpc_decoder_tpu_torch.rng.chacha_torch`,
:mod:`ldpc_decoder_tpu_torch.ops.retire`); a nonzero CUDA error from a
launch raises.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading

import numpy as np
import torch

from ldpc_decoder_tpu_torch._build import build_shared_library
from ldpc_decoder_tpu_torch.ops import phi as _phi

CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
# the sources of each library (compiled in parallel when several)
SOURCES = {name: [os.path.join(CSRC, f"{name}.cu")]
           for name in ("qc_grouped", "qc_regular", "qc_minsum", "general",
                        "probes", "datagen", "retire")}
SOURCES["qc_grouped"].append(os.path.join(CSRC, "qc_grouped_accurate.cu"))
SOURCES["qc_regular"].append(os.path.join(CSRC, "qc_regular_accurate.cu"))
# the parity kernels (parity.cuh) in their own sources, compiled beside
# their families' check and variable kernels
SOURCES["qc_grouped"].append(os.path.join(CSRC, "qc_grouped_parity.cu"))
SOURCES["qc_regular"].append(os.path.join(CSRC, "qc_regular_parity.cu"))
SOURCES["general"].append(os.path.join(CSRC, "general_accurate.cu"))
# the min-sum check kernels in their own sources: built in one source with
# their library's other kernels, those two libraries finished 42-54 s
# after the other three (chip_smoke phase 2, PERF.md)
SOURCES["general"].append(os.path.join(CSRC, "general_minsum.cu"))
SOURCES["qc_minsum"].append(os.path.join(CSRC, "qc_minsum_cn.cu"))
# every float8_e5m2 instantiation of the general library (352 kernels) in a
# fourth source, compiled beside the other three
SOURCES["general"].append(os.path.join(CSRC, "general_fp8.cu"))
# every header a source includes: hashed into each library's build key, so
# an edited header rebuilds
HEADERS = tuple(os.path.join(CSRC, h) for h in (
    "common.cuh", "sum_product.cuh", "qc_grouped.cuh", "qc_regular.cuh",
    "general.cuh", "general_e5m2.cuh", "general_minsum.cuh", "minsum.cuh",
    "parity.cuh"))
# --split-compile=0: nvcc optimizes a source's template instantiations in
# parallel, one thread per CPU. On an H100 host with 8 cores the four
# libraries, built together, take 49.6 s with it on the three large
# sources against 58.5-59.8 s with it on general.cu and qc_minsum.cu only
# (qc_regular.cu 34.1 s against 58.5 s; PERF.md)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "--split-compile=0"]
# each source's kMaxDegree: degrees 1..max are instantiated (probes: the
# most windows per output node; datagen and retire have no node degree)
MAX_DEGREES = {"qc_grouped": 16, "qc_regular": 32, "qc_minsum": 32,
               "general": 32, "probes": 6}

launch_counts = {"cn": 0, "vn": 0, "parity": 0,
                 "cn_regular": 0, "vn_regular": 0, "parity_regular": 0,
                 "parity_vec": 0, "parity_regular_vec": 0,
                 "cn_fp8": 0, "vn_fp8": 0,
                 "cn_regular_fp8": 0, "vn_regular_fp8": 0,
                 "cn_general": 0, "vn_general": 0,
                 "cn_general_fp8": 0, "vn_general_fp8": 0,
                 "cn_general_minsum": 0, "vn_general_minsum": 0,
                 "cn_general_minsum_fp8": 0, "vn_general_minsum_fp8": 0,
                 "cn_general_minsum_fp8_vec": 0,
                 "cn_group_minsum": 0, "vn_group_minsum": 0,
                 "cn_general_minsum_vec": 0, "cn_group_minsum_vec": 0,
                 "cn_regular_minsum": 0, "vn_regular_minsum": 0,
                 "probe_row_copy": 0, "probe_window": 0,
                 "chacha_bits": 0, "channel_values": 0,
                 "channel_values_vec": 0,
                 "retire_pack": 0,
                 "phi_accurate": 0}

_p, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ll = ctypes.c_longlong
# per library: {launch function: argtypes}; each returns a CUDA error code.
# Every library also exports ldpc_cuda_error_string, and each but datagen
# and retire ldpc_max_degree().
_SIGNATURES = {
    "qc_grouped": {
        "ldpc_cn_group": [_p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _f, _i,
                          _i, _i, _p],
        "ldpc_vn_group": [_p, _p, _p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _i,
                          _f, _i, _i, _i, _p],
        "ldpc_vec_lanes": [_i, _i],
        "ldpc_parity_group": [_p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _i,
                              _i, _i, _p],
        "ldpc_parity_vec_lanes": [],
    },
    "qc_regular": {
        "ldpc_cn_regular": [_p, _p, _p, _p, _i, _i, _i, _i, _i, _f, _i, _i,
                            _i, _p],
        "ldpc_vn_regular": [_p, _p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _f,
                            _i, _i, _i, _p],
        "ldpc_vec_lanes": [_i, _i],
        "ldpc_parity_regular": [_p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _p],
        "ldpc_parity_vec_lanes": [],
    },
    "qc_minsum": {
        "ldpc_cn_group_minsum": [_p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _i,
                                 _f, _f, _f, _i, _i, _p],
        "ldpc_minsum_vec_lanes": [_i, _i],
        "ldpc_vn_group_minsum": [_p, _p, _p, _p, _p, _p, _p, _i, _i, _i, _i,
                                 _i, _i, _f, _f, _i, _p],
        "ldpc_cn_regular_minsum": [_p, _p, _p, _p, _i, _i, _i, _i, _i, _f,
                                   _f, _i, _p],
        "ldpc_vn_regular_minsum": [_p, _p, _p, _p, _p, _p, _i, _i, _i, _i,
                                   _i, _f, _i, _p],
    },
    "general": {
        "ldpc_cn_general": [_p, _p, _p, _p, _i, _i, _i, _i, _i, _f, _i, _i,
                            _i, _p],
        "ldpc_vn_general": [_p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _f, _i,
                            _i, _i, _p],
        "ldpc_vec_lanes": [_i, _i],
        "ldpc_cn_general_minsum": [_p, _p, _p, _p, _i, _i, _i, _i, _i, _f,
                                   _f, _f, _i, _i, _p],
        "ldpc_minsum_vec_lanes": [_i, _i],
        "ldpc_vn_general_minsum": [_p, _p, _p, _p, _p, _i, _i, _i, _i, _i,
                                   _f, _f, _i, _p],
        "ldpc_cn_general_e5m2": [_p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _f,
                                 _i, _p],
        "ldpc_vn_general_e5m2": [_p, _p, _p, _p, _p, _p, _i, _i, _i, _i, _i,
                                 _f, _i, _p],
        "ldpc_phi_e5m2_buckets": [],
        "ldpc_phi_e5m2_bucket": [ctypes.c_uint],
    },
    "probes": {
        "ldpc_probe_row_copy": [_p, _p, _p, _p, _p, _i, _ll, _i, _i, _i, _p],
        "ldpc_probe_window": [_p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _i,
                              _i, _i, _i, _f, _i, _p],
        "ldpc_probe_window_plan": [_i, _i, _i, _i, _i, _i, _i, _p],
        "ldpc_probe_stage_runs": [_i, _i, _i, _i, _p],
    },
    "datagen": {
        "ldpc_chacha_bits": [_p, _p, ctypes.c_uint, _i, _i, _i, _p],
        "ldpc_channel_values": [_p, _p, _p, ctypes.c_uint, _i, _i, _i, _ll,
                                _i, _f, _i, _p],
        "ldpc_channel_values_vec_frames": [],
        "ldpc_chacha_bits_plan": [_i, _i, _p],
        "ldpc_channel_values_plan": [_i, _i, _i, _i, _p],
    },
    "retire": {
        "ldpc_retire_pack": [_p, _p, _p, _p, _i, _i, _i, _p],
    },
}
# message dtype codes of every library's C entries (each takes the ones
# its kernels are instantiated for and refuses the others)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
               torch.float8_e5m2: 3}
_SP_DTYPES = (torch.float32, torch.bfloat16, torch.float8_e5m2)
# the sum-product kernels' phi policies (their C entries' phi code)
PHI_POLICIES = {"fast": 0, "accurate": 1}
# the sum-product check and variable kernels' vector: at most 16 bytes of
# messages per thread and row, and at most 64 message values per thread
# (degree x lanes: registers, no spills)
VEC_BYTES = 16
VEC_FLOATS = 64
# the [nb * Z] message rows of the grouped min-sum check kernel: a row
# index is an int (the row index times B is 64-bit)
MAX_ROWS = 2**31 - 1
# the parity kernels (csrc/parity.cuh): lanes per thread of the vector
# instantiation (16 int8 lanes, one 16-byte load per row and slot; each QC
# library's ldpc_parity_vec_lanes, checked at load), and the lanes of one
# slice of their grid, whose checks all run before the next slice's: 128
# was the fastest of 16-256 at p41 and reg36 x B = 256 on an H100 (PERF.md,
# chip_smoke phases 5 and 9), 7-8 % ahead of one slice of 256
PARITY_VEC_LANES = 16
PARITY_SLICE_LANES = 128

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_e5m2_tables: dict[torch.device, torch.Tensor] = {}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "ldpc_decoder_tpu_torch/csrc/ at first use")


def library_path(name: str) -> str:
    """Build (if needed) and return the path of library ``name`` (a key of
    :data:`SOURCES`); its ``.log`` beside it holds ptxas's register and
    spill report. Safe to call for all libraries from several threads at
    once: each nvcc runs in its own process."""
    cmd = [_nvcc(), *NVCC_FLAGS]
    return build_shared_library(name, SOURCES[name], cmd, timeout=900,
                                headers=HEADERS)


def load(name: str) -> ctypes.CDLL:
    with _lock:
        if name in _libs:
            return _libs[name]
        lib = ctypes.CDLL(library_path(name))
        for fn, argtypes in _SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = _i
        lib.ldpc_cuda_error_string.argtypes = [_i]
        lib.ldpc_cuda_error_string.restype = ctypes.c_char_p
        if name in MAX_DEGREES:
            lib.ldpc_max_degree.argtypes = []
            lib.ldpc_max_degree.restype = _i
            if lib.ldpc_max_degree() != MAX_DEGREES[name]:
                raise RuntimeError(f"{name} library and MAX_DEGREES "
                                   f"disagree")
        if "ldpc_vec_lanes" in _SIGNATURES[name] and any(
                lib.ldpc_vec_lanes(code, d) != vec_lanes(dtype, d)
                for dtype, code in DTYPE_CODES.items() if dtype in _SP_DTYPES
                for d in range(1, MAX_DEGREES[name] + 1)):
            raise RuntimeError(f"{name} library and vec_lanes disagree")
        if ("ldpc_parity_vec_lanes" in _SIGNATURES[name]
                and lib.ldpc_parity_vec_lanes() != PARITY_VEC_LANES):
            raise RuntimeError(f"{name} library and PARITY_VEC_LANES "
                               f"disagree")
        if "ldpc_phi_e5m2_buckets" in _SIGNATURES[name]:
            _check_e5m2_layout(lib)
        if "ldpc_minsum_vec_lanes" in _SIGNATURES[name] and any(
                lib.ldpc_minsum_vec_lanes(code, d) != minsum_vec_lanes(
                    dtype, d)
                for dtype, code in DTYPE_CODES.items()
                for d in range(1, MAX_DEGREES[name] + 1)):
            raise RuntimeError(f"{name} library and minsum_vec_lanes "
                               f"disagree")
        _libs[name] = lib
        return lib


def _check_e5m2_layout(lib) -> None:
    """The general library's threshold table layout against ops/phi.py:
    the number of buckets, the upper clamp, and the bucket of the first
    and the last float32 of every bucket."""
    table = _phi.phi_e5m2_table()
    lib.ldpc_phi_e5m2_zero.argtypes = []
    lib.ldpc_phi_e5m2_zero.restype = ctypes.c_float
    ok = (lib.ldpc_phi_e5m2_buckets() == len(table)
          and lib.ldpc_phi_e5m2_zero() == _phi.phi_e5m2_zero())
    probes = np.concatenate(_phi.phi_e5m2_bucket_bounds())
    want = _phi.phi_e5m2_bucket_np(probes)
    if not ok or any(lib.ldpc_phi_e5m2_bucket(int(b)) != int(w)
                     for b, w in zip(probes, want)):
        raise RuntimeError("general library and ops/phi.py disagree on the "
                           "float8_e5m2 threshold table")


def phi_e5m2_table(device: torch.device) -> torch.Tensor:
    """The threshold table of the general float8_e5m2 kernels on
    ``device`` ([buckets] int32, one word a bucket: a code and its
    threshold's bits), built once per device from ops/phi.py."""
    device = torch.device(device)
    with _lock:
        if device not in _e5m2_tables:
            _e5m2_tables[device] = torch.from_numpy(
                _phi.phi_e5m2_table().view("int32").copy()).to(device)
        return _e5m2_tables[device]


def _check(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err} "
                           f"({lib.ldpc_cuda_error_string(err).decode()})")


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _fp8(name: str, dtype: torch.dtype) -> str:
    """The launch-count name of a kernel that counts its float8_e5m2
    launches apart, for ``dtype``."""
    return f"{name}_fp8" if dtype == torch.float8_e5m2 else name


def vec_lanes(dtype: torch.dtype, degree: int) -> int:
    """Lanes per thread of the vector instantiation of the sum-product
    check and variable kernels (``VecLanes`` in csrc/sum_product.cuh): 16
    bytes of messages, halved until ``degree`` times the lanes is at most
    :data:`VEC_FLOATS`."""
    cap = VEC_BYTES // torch.empty((), dtype=dtype).element_size()
    fit = 1 << ((VEC_FLOATS // degree).bit_length() - 1)
    return min(cap, fit)


def lanes_per_thread(B: int, dtype: torch.dtype, degree: int) -> int:
    """The instantiation a sum-product check or variable launch takes for
    B lanes of ``dtype`` messages at ``degree``: :func:`vec_lanes` when B is
    a multiple of it (every row then starts on a vector boundary), else 1."""
    v = vec_lanes(dtype, degree)
    return v if B % v == 0 else 1


def _aligned(v: int, *tensors) -> int:
    """``v``, or 1 when a tensor's base is not aligned to ``v`` of its
    elements (a view at an odd offset)."""
    for t in tensors:
        if t is not None and t.data_ptr() % (v * t.element_size()):
            return 1
    return v


def _lanes(B: int, degree: int, msgs: torch.Tensor, *others) -> int:
    """:func:`lanes_per_thread` for a launch on these tensors, or 1 when a
    tensor's base is not aligned to that many of its elements (a view at an
    odd offset): chosen before the launch, from the layout alone."""
    return _aligned(lanes_per_thread(B, msgs.dtype, degree), msgs, *others)


def minsum_vec_lanes(dtype: torch.dtype, degree: int) -> int:
    """Lanes per thread of the vector instantiation of the min-sum check
    kernels (``MinsumLanes`` in csrc/minsum.cuh): 16 bytes of messages at
    every degree, since their per-lane state (m1, m2, pos and the sign bits)
    does not grow with it."""
    return VEC_BYTES // torch.empty((), dtype=dtype).element_size()


def minsum_lanes_per_thread(B: int, dtype: torch.dtype, degree: int) -> int:
    """The instantiation a min-sum check launch takes for B lanes of
    ``dtype`` messages at ``degree``: :func:`minsum_vec_lanes` when B is a
    multiple of it, else 1."""
    v = minsum_vec_lanes(dtype, degree)
    return v if B % v == 0 else 1


def _minsum_lanes(B: int, degree: int, msgs: torch.Tensor, *others) -> int:
    """:func:`minsum_lanes_per_thread` for a launch on these tensors, or 1
    for a base off the vector boundary, as :func:`_lanes`."""
    return _aligned(minsum_lanes_per_thread(B, msgs.dtype, degree), msgs,
                    *others)


def _count_lanes(name: str, lanes: int) -> None:
    """One launch of ``name``, counted again under ``name``_vec when it
    took the vector instantiation."""
    launch_counts[name] += 1
    if lanes > 1:
        launch_counts[f"{name}_vec"] += 1


def parity_lanes_per_thread(B: int) -> int:
    """The instantiation a parity launch takes for B lanes:
    :data:`PARITY_VEC_LANES` when B is a multiple of it, else 1."""
    return PARITY_VEC_LANES if B % PARITY_VEC_LANES == 0 else 1


def _parity_launch(B: int, lanes: int | None, slice_lanes: int | None,
                   bits, syn) -> tuple[int, int]:
    """(lanes, slice_lanes) of a parity launch: ``lanes`` None picks them by
    layout (:func:`parity_lanes_per_thread`, or 1 for a base off the
    16-byte boundary); ``slice_lanes`` None is :data:`PARITY_SLICE_LANES`;
    either way the slice is cut to the power of two that holds B."""
    if lanes is None:
        lanes = _aligned(parity_lanes_per_thread(B), bits, syn)
    if slice_lanes is None:
        slice_lanes = PARITY_SLICE_LANES
    return lanes, max(lanes, min(slice_lanes, 1 << (B - 1).bit_length()))


def check_phi(phi: str) -> None:
    """Raise ValueError unless ``phi`` names a φ policy."""
    if phi not in PHI_POLICIES:
        raise ValueError(f"unknown phi policy {phi!r}")


def _count_sum_product(name: str, dtype: torch.dtype, phi: str) -> None:
    launch_counts[_fp8(name, dtype)] += 1
    if phi == "accurate":
        launch_counts["phi_accurate"] += 1


def cn_group(msgs_v, syn, r_c, src, shift, g, Z: int, B: int,
             pre: float, phi: str = "fast") -> None:
    """Check-node kernel for one check-degree group ``g``; ``phi`` "fast"
    (the decoder's) or "accurate" (common.cuh's phi_abs)."""
    lib = load("qc_grouped")
    lanes = _lanes(B, g.degree, msgs_v, syn, r_c)
    err = lib.ldpc_cn_group(
        _ptr(msgs_v), _ptr(syn), _ptr(r_c), _ptr(src), _ptr(shift),
        g.node_start, g.count, g.degree, g.block_start, Z, B, pre,
        DTYPE_CODES[msgs_v.dtype], lanes, PHI_POLICIES[phi], _stream(msgs_v))
    _check(lib, err, "check-node kernel")
    _count_sum_product("cn", msgs_v.dtype, phi)


def vn_group(r_c, llr, msgs_v, bits, fresh, src, shift, g, Z: int, B: int,
             pre: float, phi: str = "fast") -> None:
    """Variable-node kernel for one variable-degree group ``g``; ``bits``
    and ``fresh`` may be None; ``phi`` as in :func:`cn_group`."""
    lib = load("qc_grouped")
    lanes = _lanes(B, g.degree, r_c, llr, msgs_v, bits, fresh)
    err = lib.ldpc_vn_group(
        _ptr(r_c), _ptr(llr), _ptr(msgs_v), _ptr(bits), _ptr(fresh),
        _ptr(src), _ptr(shift), g.node_start, g.count, g.degree,
        g.block_start, Z, B, pre, DTYPE_CODES[r_c.dtype], lanes,
        PHI_POLICIES[phi], _stream(r_c))
    _check(lib, err, "variable-node kernel")
    _count_sum_product("vn", r_c.dtype, phi)


def parity_group(bits, syn, flags, src, shift, g, Z: int, B: int,
                 lanes: int | None = None,
                 slice_lanes: int | None = None) -> None:
    """Parity kernel for one check-degree group ``g``: flags [B] int32 set
    to 1 where violated. ``lanes`` None picks the instantiation by layout, 1
    asks for the one-lane one; ``slice_lanes`` None takes
    :data:`PARITY_SLICE_LANES` (chip_smoke times others beside it)."""
    lib = load("qc_grouped")
    lanes, slice_lanes = _parity_launch(B, lanes, slice_lanes, bits, syn)
    err = lib.ldpc_parity_group(
        _ptr(bits), _ptr(syn), _ptr(flags), _ptr(src), _ptr(shift),
        g.node_start, g.count, g.degree, g.block_start, Z, B, lanes,
        slice_lanes, _stream(bits))
    _check(lib, err, "parity kernel")
    _count_lanes("parity", lanes)


def cn_regular(msgs_v, syn, r_c, tables, pre: float,
               phi: str = "fast", lanes: int | None = None) -> None:
    """Regular check-node kernel over all R checks (one launch); φ's clamp
    is :func:`~ldpc_decoder_tpu_torch.ops.phi.phi_high` of the message
    dtype, compiled into the kernel; ``phi`` as in :func:`cn_group`.
    ``lanes``: None picks the instantiation by layout (:func:`_lanes`), 1
    asks for the one-lane one (chip_smoke times it beside the vector)."""
    lib = load("qc_regular")
    B = msgs_v.shape[-1]
    if lanes is None:
        lanes = _lanes(B, tables.d_c, msgs_v, syn, r_c)
    err = lib.ldpc_cn_regular(
        _ptr(msgs_v), _ptr(syn), _ptr(r_c), _ptr(tables.cn_read), tables.R,
        tables.d_c, tables.d_v, tables.Z, B, pre, DTYPE_CODES[msgs_v.dtype],
        lanes, PHI_POLICIES[phi], _stream(msgs_v))
    _check(lib, err, "regular check-node kernel")
    _count_sum_product("cn_regular", msgs_v.dtype, phi)


def vn_regular(r_c, llr, msgs_v, bits, fresh, tables, pre: float,
               phi: str = "fast", lanes: int | None = None) -> None:
    """Regular variable-node kernel over all C variables (one launch);
    ``bits`` and ``fresh`` may be None; ``phi`` and ``lanes`` as in
    :func:`cn_regular`."""
    lib = load("qc_regular")
    B = r_c.shape[-1]
    if lanes is None:
        lanes = _lanes(B, tables.d_v, r_c, llr, msgs_v, bits, fresh)
    err = lib.ldpc_vn_regular(
        _ptr(r_c), _ptr(llr), _ptr(msgs_v), _ptr(bits), _ptr(fresh),
        _ptr(tables.vn_read), tables.C, tables.d_v, tables.d_c, tables.Z, B,
        pre, DTYPE_CODES[r_c.dtype], lanes, PHI_POLICIES[phi], _stream(r_c))
    _check(lib, err, "regular variable-node kernel")
    _count_sum_product("vn_regular", r_c.dtype, phi)


def parity_regular(bits, syn, flags, tables, lanes: int | None = None,
                   slice_lanes: int | None = None) -> None:
    """Regular parity kernel over all R checks: flags [B] int32 set to 1
    where violated; ``lanes`` and ``slice_lanes`` as in
    :func:`parity_group`."""
    lib = load("qc_regular")
    B = bits.shape[-1]
    lanes, slice_lanes = _parity_launch(B, lanes, slice_lanes, bits, syn)
    err = lib.ldpc_parity_regular(
        _ptr(bits), _ptr(syn), _ptr(flags), _ptr(tables.cn_read), tables.R,
        tables.d_c, tables.Z, B, lanes, slice_lanes, _stream(bits))
    _check(lib, err, "regular parity kernel")
    _count_lanes("parity_regular", lanes)


def cn_general(msgs_v, syn, r_c, perm_v2c, bucket, pre: float,
               phi: str = "fast") -> None:
    """General sum-product check-node kernel for one check bucket; ``phi``
    as in :func:`cn_group` (float8_e5m2 messages on "fast" take the
    threshold-lookup kernel of csrc/general_e5m2.cuh)."""
    lib = load("general")
    B = msgs_v.shape[-1]
    lanes = _lanes(B, bucket.degree, msgs_v, syn, r_c)
    if msgs_v.dtype == torch.float8_e5m2 and phi == "fast":
        err = lib.ldpc_cn_general_e5m2(
            _ptr(msgs_v), _ptr(syn), _ptr(r_c), _ptr(perm_v2c),
            _ptr(phi_e5m2_table(msgs_v.device)), bucket.row_start,
            bucket.count, bucket.degree, bucket.edge_start, B, pre, lanes,
            _stream(msgs_v))
        _check(lib, err, "general float8_e5m2 check-node kernel")
        _count_sum_product("cn_general", msgs_v.dtype, phi)
        return
    err = lib.ldpc_cn_general(
        _ptr(msgs_v), _ptr(syn), _ptr(r_c), _ptr(perm_v2c), bucket.row_start,
        bucket.count, bucket.degree, bucket.edge_start, B, pre,
        DTYPE_CODES[msgs_v.dtype], lanes, PHI_POLICIES[phi], _stream(msgs_v))
    _check(lib, err, "general check-node kernel")
    _count_sum_product("cn_general", msgs_v.dtype, phi)


def vn_general(r_c, llr, msgs_v, bits, perm_c2v, bucket, pre: float,
               phi: str = "fast") -> None:
    """General sum-product variable-node kernel for one variable bucket;
    ``bits`` may be None; ``phi`` as in :func:`cn_general`."""
    lib = load("general")
    B = r_c.shape[-1]
    lanes = _lanes(B, bucket.degree, r_c, llr, msgs_v, bits)
    if r_c.dtype == torch.float8_e5m2 and phi == "fast":
        err = lib.ldpc_vn_general_e5m2(
            _ptr(r_c), _ptr(llr), _ptr(msgs_v), _ptr(bits), _ptr(perm_c2v),
            _ptr(phi_e5m2_table(r_c.device)), bucket.row_start,
            bucket.count, bucket.degree, bucket.edge_start, B, pre, lanes,
            _stream(r_c))
        _check(lib, err, "general float8_e5m2 variable-node kernel")
        _count_sum_product("vn_general", r_c.dtype, phi)
        return
    err = lib.ldpc_vn_general(
        _ptr(r_c), _ptr(llr), _ptr(msgs_v), _ptr(bits), _ptr(perm_c2v),
        bucket.row_start, bucket.count, bucket.degree, bucket.edge_start, B,
        pre, DTYPE_CODES[r_c.dtype], lanes, PHI_POLICIES[phi], _stream(r_c))
    _check(lib, err, "general variable-node kernel")
    _count_sum_product("vn_general", r_c.dtype, phi)


def cn_general_minsum(msgs_v, syn, r_c, perm_v2c, bucket, alpha: float,
                      beta: float, qscale: float,
                      lanes: int | None = None) -> None:
    """General min-sum check-node kernel for one check bucket (``alpha``
    for its degree). ``lanes``: None picks the instantiation by layout
    (:func:`_minsum_lanes`), 1 asks for the one-lane one (chip_smoke times
    it beside the vector one)."""
    lib = load("general")
    B = msgs_v.shape[-1]
    if lanes is None:
        lanes = _minsum_lanes(B, bucket.degree, msgs_v, syn, r_c)
    err = lib.ldpc_cn_general_minsum(
        _ptr(msgs_v), _ptr(syn), _ptr(r_c), _ptr(perm_v2c), bucket.row_start,
        bucket.count, bucket.degree, bucket.edge_start, B, alpha, beta,
        qscale, DTYPE_CODES[msgs_v.dtype], lanes, _stream(msgs_v))
    _check(lib, err, "general min-sum check-node kernel")
    _count_lanes(_fp8("cn_general_minsum", msgs_v.dtype), lanes)


def vn_general_minsum(r_c, llr, msgs_v, bits, perm_c2v, bucket,
                      clamp: float, qscale: float) -> None:
    """General min-sum variable-node kernel for one variable bucket;
    ``bits`` may be None."""
    lib = load("general")
    err = lib.ldpc_vn_general_minsum(
        _ptr(r_c), _ptr(llr), _ptr(msgs_v), _ptr(bits), _ptr(perm_c2v),
        bucket.row_start, bucket.count, bucket.degree, bucket.edge_start,
        r_c.shape[-1], clamp, qscale, DTYPE_CODES[r_c.dtype], _stream(r_c))
    _check(lib, err, "general min-sum variable-node kernel")
    launch_counts[_fp8("vn_general_minsum", r_c.dtype)] += 1


def cn_group_minsum(msgs_v, syn, r_c, src, shift, g, Z: int, B: int,
                    alpha: float, beta: float, qscale: float,
                    lanes: int | None = None) -> None:
    """Min-sum check-node kernel for one check-degree group ``g`` (``alpha``
    for its degree); ``lanes`` as in :func:`cn_general_minsum`."""
    lib = load("qc_minsum")
    if msgs_v.numel() // B > MAX_ROWS:
        raise ValueError(f"{msgs_v.numel() // B} message rows: the grouped "
                         f"min-sum check kernel indexes at most {MAX_ROWS}")
    if lanes is None:
        lanes = _minsum_lanes(B, g.degree, msgs_v, syn, r_c)
    err = lib.ldpc_cn_group_minsum(
        _ptr(msgs_v), _ptr(syn), _ptr(r_c), _ptr(src), _ptr(shift),
        g.node_start, g.count, g.degree, g.block_start, Z, B, alpha, beta,
        qscale, DTYPE_CODES[msgs_v.dtype], lanes, _stream(msgs_v))
    _check(lib, err, "grouped min-sum check-node kernel")
    _count_lanes("cn_group_minsum", lanes)


def vn_group_minsum(r_c, llr, msgs_v, bits, fresh, src, shift, g, Z: int,
                    B: int, clamp: float, qscale: float) -> None:
    """Min-sum variable-node kernel for one variable-degree group ``g``;
    ``bits`` and ``fresh`` may be None."""
    lib = load("qc_minsum")
    err = lib.ldpc_vn_group_minsum(
        _ptr(r_c), _ptr(llr), _ptr(msgs_v), _ptr(bits), _ptr(fresh),
        _ptr(src), _ptr(shift), g.node_start, g.count, g.degree,
        g.block_start, Z, B, clamp, qscale, DTYPE_CODES[r_c.dtype],
        _stream(r_c))
    _check(lib, err, "grouped min-sum variable-node kernel")
    launch_counts["vn_group_minsum"] += 1


def cn_regular_minsum(msgs_v, syn, r_c, tables, alpha: float,
                      beta: float) -> None:
    """Regular min-sum check-node kernel over all R checks (one launch)."""
    lib = load("qc_minsum")
    err = lib.ldpc_cn_regular_minsum(
        _ptr(msgs_v), _ptr(syn), _ptr(r_c), _ptr(tables.cn_read), tables.R,
        tables.d_c, tables.d_v, tables.Z, msgs_v.shape[-1], alpha, beta,
        DTYPE_CODES[msgs_v.dtype], _stream(msgs_v))
    _check(lib, err, "regular min-sum check-node kernel")
    launch_counts["cn_regular_minsum"] += 1


def vn_regular_minsum(r_c, llr, msgs_v, bits, fresh, tables,
                      clamp: float) -> None:
    """Regular min-sum variable-node kernel over all C variables (one
    launch); ``bits`` and ``fresh`` may be None."""
    lib = load("qc_minsum")
    err = lib.ldpc_vn_regular_minsum(
        _ptr(r_c), _ptr(llr), _ptr(msgs_v), _ptr(bits), _ptr(fresh),
        _ptr(tables.vn_read), tables.C, tables.d_v, tables.d_c, tables.Z,
        r_c.shape[-1], clamp, DTYPE_CODES[r_c.dtype], _stream(r_c))
    _check(lib, err, "regular min-sum variable-node kernel")
    launch_counts["vn_regular_minsum"] += 1


def probe_row_copy(src, out, blocks, shifts, index, n_rows: int, Z: int,
                   row_bytes: int, bytes_per_thread: int) -> None:
    """The row-copy probe over ``n_rows`` output rows: from the (block,
    shift) table when ``index`` is None, else from the int32 or int64
    ``index``."""
    lib = load("probes")
    mode = 0 if index is None else 1 if index.dtype == torch.int32 else 2
    err = lib.ldpc_probe_row_copy(
        _ptr(src), _ptr(out), _ptr(blocks), _ptr(shifts), _ptr(index), mode,
        n_rows, Z, row_bytes, bytes_per_thread, _stream(src))
    _check(lib, err, "row-copy probe")
    launch_counts["probe_row_copy"] += 1


def probe_window(src, syn, out, blocks, shifts, degree: int, k: int,
                 mode: int, out_mode: int, phi_live: bool, phi: str,
                 rows: int, pre: float) -> None:
    """The window-stream probe over ``blocks.numel() // degree`` output
    nodes of src [NB, Z, W]; ``syn`` may be None; ``phi`` the policy of a
    live φ."""
    lib = load("probes")
    _, Z, W = src.shape
    err = lib.ldpc_probe_window(
        _ptr(src), _ptr(syn), _ptr(out), _ptr(blocks), _ptr(shifts),
        blocks.numel() // degree, degree, k, mode, out_mode, int(phi_live),
        PHI_POLICIES[phi], Z, W, rows, pre, DTYPE_CODES[src.dtype],
        _stream(src))
    _check(lib, err, "window-stream probe")
    launch_counts["probe_window"] += 1


# channel codes of ldpc_channel_values
CHANNEL_CODES = {"bsc": 0, "erasure": 1, "awgn": 2}


def chacha_bits(bits, packed, start: int, n_vars: int, n_frames: int,
                n_words: int) -> None:
    """D1: a pool's reference bits [n_vars, n_frames] int8 and their packed
    words [n_frames, n_words] int32 from the streams seeded start + 32 g."""
    lib = load("datagen")
    err = lib.ldpc_chacha_bits(_ptr(bits), _ptr(packed), start, n_vars,
                               n_frames, n_words, _stream(bits))
    _check(lib, err, "reference-bits kernel")
    launch_counts["chacha_bits"] += 1


def channel_values(values, bits, pos, start: int, n_vars: int, n_tx: int,
                   n_frames: int, channel: str, noise: float,
                   frames: int) -> None:
    """D2: channel values of ``n_frames`` frames into the rows of
    ``values`` (row pos[v], or v when ``pos`` is None; its row stride taken
    from the tensor), 0.0 from variable ``n_tx`` on; ``frames`` a store,
    4 (the vector instantiation, counted again under
    ``channel_values_vec``) or 1 (the C entry refuses 4 where the rows or
    the bits are not aligned for it)."""
    lib = load("datagen")
    err = lib.ldpc_channel_values(
        _ptr(values), _ptr(bits), _ptr(pos), start, n_vars, n_tx, n_frames,
        values.stride(0), CHANNEL_CODES[channel], noise, frames,
        _stream(values))
    _check(lib, err, "channel-values kernel")
    launch_counts["channel_values"] += 1
    if frames > 1:
        launch_counts["channel_values_vec"] += 1


def retire_pack(bits, src_row, lane_frame, results, n_vars: int,
                n_words: int, B: int) -> None:
    """The retire pack: the words of every lane b with lane_frame[b] >= 0
    of bits [n_vars, B] int8 into row lane_frame[b] of results [n_pool,
    n_words] int32, natural variable u read from row src_row[u]."""
    lib = load("retire")
    err = lib.ldpc_retire_pack(_ptr(bits), _ptr(src_row), _ptr(lane_frame),
                               _ptr(results), n_vars, n_words, B,
                               _stream(bits))
    _check(lib, err, "retire pack kernel")
    launch_counts["retire_pack"] += 1
