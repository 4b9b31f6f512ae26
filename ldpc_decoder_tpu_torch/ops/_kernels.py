"""Build, load and launch the CUDA kernels of ``csrc/``.

Five sources, one shared library each: ``qc_grouped.cu`` (the grouped
family's sum-product and parity kernels, one launch per degree group),
``qc_regular.cu`` (the regular family's, one launch per pass),
``qc_minsum.cu`` (the min-sum check and variable kernels of both QC
families, int8 messages in the grouped one), ``general.cu`` (the
general any-alist path, sum-product and min-sum, one launch per degree
bucket) and ``probes.cu`` (the measurement probes of
:mod:`ldpc_decoder_tpu_torch.probes`, which no decode runs); all include
``common.cuh``. Each is compiled
by ``nvcc`` for ``sm_90a`` into a library with a plain ``extern "C"``
interface (no PyTorch headers, so it builds in seconds) at first use, into
the git-ignored ``ldpc_decoder_tpu_torch/build/``; a changed source or
header rebuilds. Fast math is never enabled: φ's accuracy near x = 5
carries the decoder.

Each launch function below launches one kernel on the current torch
stream and adds one to its entry of :data:`launch_counts` (the port's only
global state), so a run can show that its main path went through the
kernels. The QC sum-product kernels count their float8_e5m2 launches
apart (``cn_fp8``, ``vn_fp8``, ``cn_regular_fp8``, ``vn_regular_fp8``),
since those are the float8 branches of other TPU kernels' rows; the
min-sum kernels count every message dtype under one name; the probes
count ``probe_row_copy`` and ``probe_window``. Argument checking is the
callers' job (:mod:`ldpc_decoder_tpu_torch.ops.qc_grouped`,
:mod:`ldpc_decoder_tpu_torch.ops.qc_regular`,
:mod:`ldpc_decoder_tpu_torch.ops.general`,
:mod:`ldpc_decoder_tpu_torch.probes.kernels`); a nonzero CUDA error from a
launch raises.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading

import torch

from ldpc_decoder_tpu_torch._build import build_shared_library

CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
SOURCES = {name: os.path.join(CSRC, f"{name}.cu")
           for name in ("qc_grouped", "qc_regular", "qc_minsum", "general",
                        "probes")}
HEADERS = (os.path.join(CSRC, "common.cuh"),)
# --split-compile=0: nvcc optimizes a source's template instantiations in
# parallel, one thread per CPU. On an H100 host with 8 cores the four
# libraries, built together, take 49.6 s with it on the three large
# sources against 58.5-59.8 s with it on general.cu and qc_minsum.cu only
# (qc_regular.cu 34.1 s against 58.5 s; PERF.md)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "--split-compile=0"]
# each source's kMaxDegree: degrees 1..max are instantiated (probes: the
# most windows per output node)
MAX_DEGREES = {"qc_grouped": 16, "qc_regular": 32, "qc_minsum": 32,
               "general": 32, "probes": 6}

launch_counts = {"cn": 0, "vn": 0, "parity": 0,
                 "cn_regular": 0, "vn_regular": 0, "parity_regular": 0,
                 "cn_fp8": 0, "vn_fp8": 0,
                 "cn_regular_fp8": 0, "vn_regular_fp8": 0,
                 "cn_general": 0, "vn_general": 0,
                 "cn_general_minsum": 0, "vn_general_minsum": 0,
                 "cn_group_minsum": 0, "vn_group_minsum": 0,
                 "cn_regular_minsum": 0, "vn_regular_minsum": 0,
                 "probe_row_copy": 0, "probe_window": 0}

_p, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ll = ctypes.c_longlong
# per library: {launch function: argtypes}; each returns a CUDA error code.
# Every library also exports ldpc_max_degree() and ldpc_cuda_error_string.
_SIGNATURES = {
    "qc_grouped": {
        "ldpc_cn_group": [_p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _f, _i,
                          _p],
        "ldpc_vn_group": [_p, _p, _p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _i,
                          _f, _i, _p],
        "ldpc_parity_group": [_p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _i,
                              _p],
    },
    "qc_regular": {
        "ldpc_cn_regular": [_p, _p, _p, _p, _i, _i, _i, _i, _i, _f, _i, _p],
        "ldpc_vn_regular": [_p, _p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _f,
                            _i, _p],
        "ldpc_parity_regular": [_p, _p, _p, _p, _i, _i, _i, _i, _p],
    },
    "qc_minsum": {
        "ldpc_cn_group_minsum": [_p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _i,
                                 _f, _f, _f, _i, _p],
        "ldpc_vn_group_minsum": [_p, _p, _p, _p, _p, _p, _p, _i, _i, _i, _i,
                                 _i, _i, _f, _f, _i, _p],
        "ldpc_cn_regular_minsum": [_p, _p, _p, _p, _i, _i, _i, _i, _i, _f,
                                   _f, _i, _p],
        "ldpc_vn_regular_minsum": [_p, _p, _p, _p, _p, _p, _i, _i, _i, _i,
                                   _i, _f, _i, _p],
    },
    "general": {
        "ldpc_cn_general": [_p, _p, _p, _p, _i, _i, _i, _i, _i, _f, _i, _p],
        "ldpc_vn_general": [_p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _f, _i,
                            _p],
        "ldpc_cn_general_minsum": [_p, _p, _p, _p, _i, _i, _i, _i, _i, _f,
                                   _f, _f, _i, _p],
        "ldpc_vn_general_minsum": [_p, _p, _p, _p, _p, _i, _i, _i, _i, _i,
                                   _f, _f, _i, _p],
    },
    "probes": {
        "ldpc_probe_row_copy": [_p, _p, _p, _p, _p, _i, _ll, _i, _i, _i, _p],
        "ldpc_probe_window": [_p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _i,
                              _i, _i, _f, _i, _p],
    },
}
# message dtype codes of every library's C entries (each takes the ones
# its kernels are instantiated for and refuses the others)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
               torch.float8_e5m2: 3}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


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
    return build_shared_library(name, [SOURCES[name]], cmd, timeout=900,
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
        lib.ldpc_max_degree.argtypes = []
        lib.ldpc_max_degree.restype = _i
        if lib.ldpc_max_degree() != MAX_DEGREES[name]:
            raise RuntimeError(f"{name} library and MAX_DEGREES disagree")
        _libs[name] = lib
        return lib


def _check(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err} "
                           f"({lib.ldpc_cuda_error_string(err).decode()})")


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _fp8(name: str, dtype: torch.dtype) -> str:
    """The launch-count name of a sum-product kernel for ``dtype``."""
    return f"{name}_fp8" if dtype == torch.float8_e5m2 else name


def cn_group(msgs_v, syn, r_c, src, shift, g, Z: int, B: int,
             pre: float) -> None:
    """Check-node kernel for one check-degree group ``g``."""
    lib = load("qc_grouped")
    err = lib.ldpc_cn_group(
        _ptr(msgs_v), _ptr(syn), _ptr(r_c), _ptr(src), _ptr(shift),
        g.node_start, g.count, g.degree, g.block_start, Z, B, pre,
        DTYPE_CODES[msgs_v.dtype], _stream(msgs_v))
    _check(lib, err, "check-node kernel")
    launch_counts[_fp8("cn", msgs_v.dtype)] += 1


def vn_group(r_c, llr, msgs_v, bits, fresh, src, shift, g, Z: int, B: int,
             pre: float) -> None:
    """Variable-node kernel for one variable-degree group ``g``; ``bits``
    and ``fresh`` may be None."""
    lib = load("qc_grouped")
    err = lib.ldpc_vn_group(
        _ptr(r_c), _ptr(llr), _ptr(msgs_v), _ptr(bits), _ptr(fresh),
        _ptr(src), _ptr(shift), g.node_start, g.count, g.degree,
        g.block_start, Z, B, pre, DTYPE_CODES[r_c.dtype],
        _stream(r_c))
    _check(lib, err, "variable-node kernel")
    launch_counts[_fp8("vn", r_c.dtype)] += 1


def parity_group(bits, syn, flags, src, shift, g, Z: int, B: int) -> None:
    """Parity kernel for one check-degree group ``g``: flags [B] int32."""
    lib = load("qc_grouped")
    err = lib.ldpc_parity_group(
        _ptr(bits), _ptr(syn), _ptr(flags), _ptr(src), _ptr(shift),
        g.node_start, g.count, g.degree, g.block_start, Z, B, _stream(bits))
    _check(lib, err, "parity kernel")
    launch_counts["parity"] += 1


def cn_regular(msgs_v, syn, r_c, tables, pre: float) -> None:
    """Regular check-node kernel over all R checks (one launch); φ's clamp
    is :func:`~ldpc_decoder_tpu_torch.ops.phi.phi_high` of the message
    dtype, compiled into the kernel."""
    lib = load("qc_regular")
    err = lib.ldpc_cn_regular(
        _ptr(msgs_v), _ptr(syn), _ptr(r_c), _ptr(tables.cn_read), tables.R,
        tables.d_c, tables.d_v, tables.Z, msgs_v.shape[-1], pre,
        DTYPE_CODES[msgs_v.dtype], _stream(msgs_v))
    _check(lib, err, "regular check-node kernel")
    launch_counts[_fp8("cn_regular", msgs_v.dtype)] += 1


def vn_regular(r_c, llr, msgs_v, bits, fresh, tables, pre: float) -> None:
    """Regular variable-node kernel over all C variables (one launch);
    ``bits`` and ``fresh`` may be None."""
    lib = load("qc_regular")
    err = lib.ldpc_vn_regular(
        _ptr(r_c), _ptr(llr), _ptr(msgs_v), _ptr(bits), _ptr(fresh),
        _ptr(tables.vn_read), tables.C, tables.d_v, tables.d_c, tables.Z,
        r_c.shape[-1], pre, DTYPE_CODES[r_c.dtype], _stream(r_c))
    _check(lib, err, "regular variable-node kernel")
    launch_counts[_fp8("vn_regular", r_c.dtype)] += 1


def parity_regular(bits, syn, flags, tables) -> None:
    """Regular parity kernel over all R checks: flags [B] int32."""
    lib = load("qc_regular")
    err = lib.ldpc_parity_regular(
        _ptr(bits), _ptr(syn), _ptr(flags), _ptr(tables.cn_read), tables.R,
        tables.d_c, tables.Z, bits.shape[-1], _stream(bits))
    _check(lib, err, "regular parity kernel")
    launch_counts["parity_regular"] += 1


def cn_general(msgs_v, syn, r_c, perm_v2c, bucket, pre: float) -> None:
    """General sum-product check-node kernel for one check bucket."""
    lib = load("general")
    err = lib.ldpc_cn_general(
        _ptr(msgs_v), _ptr(syn), _ptr(r_c), _ptr(perm_v2c), bucket.row_start,
        bucket.count, bucket.degree, bucket.edge_start, msgs_v.shape[-1], pre,
        DTYPE_CODES[msgs_v.dtype], _stream(msgs_v))
    _check(lib, err, "general check-node kernel")
    launch_counts["cn_general"] += 1


def vn_general(r_c, llr, msgs_v, bits, perm_c2v, bucket, pre: float) -> None:
    """General sum-product variable-node kernel for one variable bucket;
    ``bits`` may be None."""
    lib = load("general")
    err = lib.ldpc_vn_general(
        _ptr(r_c), _ptr(llr), _ptr(msgs_v), _ptr(bits), _ptr(perm_c2v),
        bucket.row_start, bucket.count, bucket.degree, bucket.edge_start,
        r_c.shape[-1], pre, DTYPE_CODES[r_c.dtype], _stream(r_c))
    _check(lib, err, "general variable-node kernel")
    launch_counts["vn_general"] += 1


def cn_general_minsum(msgs_v, syn, r_c, perm_v2c, bucket, alpha: float,
                      beta: float, qscale: float) -> None:
    """General min-sum check-node kernel for one check bucket (``alpha``
    for its degree)."""
    lib = load("general")
    err = lib.ldpc_cn_general_minsum(
        _ptr(msgs_v), _ptr(syn), _ptr(r_c), _ptr(perm_v2c), bucket.row_start,
        bucket.count, bucket.degree, bucket.edge_start, msgs_v.shape[-1],
        alpha, beta, qscale, DTYPE_CODES[msgs_v.dtype], _stream(msgs_v))
    _check(lib, err, "general min-sum check-node kernel")
    launch_counts["cn_general_minsum"] += 1


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
    launch_counts["vn_general_minsum"] += 1


def cn_group_minsum(msgs_v, syn, r_c, src, shift, g, Z: int, B: int,
                    alpha: float, beta: float, qscale: float) -> None:
    """Min-sum check-node kernel for one check-degree group ``g`` (``alpha``
    for its degree)."""
    lib = load("qc_minsum")
    err = lib.ldpc_cn_group_minsum(
        _ptr(msgs_v), _ptr(syn), _ptr(r_c), _ptr(src), _ptr(shift),
        g.node_start, g.count, g.degree, g.block_start, Z, B, alpha, beta,
        qscale, DTYPE_CODES[msgs_v.dtype], _stream(msgs_v))
    _check(lib, err, "grouped min-sum check-node kernel")
    launch_counts["cn_group_minsum"] += 1


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
                 mode: int, out_mode: int, phi_live: bool, rows: int,
                 pre: float) -> None:
    """The window-stream probe over ``blocks.numel() // degree`` output
    nodes of src [NB, Z, W]; ``syn`` may be None."""
    lib = load("probes")
    _, Z, W = src.shape
    err = lib.ldpc_probe_window(
        _ptr(src), _ptr(syn), _ptr(out), _ptr(blocks), _ptr(shifts),
        blocks.numel() // degree, degree, k, mode, out_mode, int(phi_live),
        Z, W, rows, pre, DTYPE_CODES[src.dtype], _stream(src))
    _check(lib, err, "window-stream probe")
    launch_counts["probe_window"] += 1
