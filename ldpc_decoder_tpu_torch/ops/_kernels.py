"""Build, load and launch the CUDA kernels of ``csrc/qc_grouped.cu``.

The source is compiled by ``nvcc`` for ``sm_90a`` into a shared library with
a plain ``extern "C"`` interface (no PyTorch headers, so it builds in
seconds) at first use, into the git-ignored ``ldpc_decoder_tpu_torch/build/``;
a changed source rebuilds. Fast math is never enabled: φ's accuracy near
x = 5 carries the decoder.

Each launch function below launches one kernel for one degree group on the
current torch stream and adds one to its entry of :data:`launch_counts`
(the port's only global state), so a run can show that its main path went
through the kernels. Argument checking is the callers' job
(:mod:`ldpc_decoder_tpu_torch.ops.qc_grouped`); a nonzero CUDA error from a
launch raises.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading

import torch

from ldpc_decoder_tpu_torch._build import build_shared_library

SOURCE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc", "qc_grouped.cu")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
MAX_DEGREE = 16  # kMaxDegree of the source: the instantiated degrees 1..16

launch_counts = {"cn": 0, "vn": 0, "parity": 0}

_lock = threading.Lock()
_lib = None


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "csrc/qc_grouped.cu at first use")


def library_path() -> str:
    """Build (if needed) and return the kernels' shared library path; its
    ``.log`` beside it holds ptxas's register and spill report."""
    return build_shared_library("qc_grouped", [SOURCE],
                                [_nvcc(), *NVCC_FLAGS], timeout=900)


def load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(library_path())
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.ldpc_qc_max_degree.argtypes = []
        lib.ldpc_qc_max_degree.restype = i
        lib.ldpc_cuda_error_string.argtypes = [i]
        lib.ldpc_cuda_error_string.restype = ctypes.c_char_p
        lib.ldpc_cn_group.argtypes = [p, p, p, p, p, i, i, i, i, i, i, f, i, p]
        lib.ldpc_cn_group.restype = i
        lib.ldpc_vn_group.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i,
                                      f, i, p]
        lib.ldpc_vn_group.restype = i
        lib.ldpc_parity_group.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p]
        lib.ldpc_parity_group.restype = i
        if lib.ldpc_qc_max_degree() != MAX_DEGREE:
            raise RuntimeError("kernel library and MAX_DEGREE disagree")
        _lib = lib
        return _lib


def _check(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err} "
                           f"({lib.ldpc_cuda_error_string(err).decode()})")


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def cn_group(msgs_v, syn, r_c, src, shift, g, Z: int, B: int,
             pre: float) -> None:
    """Check-node kernel for one check-degree group ``g``."""
    lib = load()
    err = lib.ldpc_cn_group(
        _ptr(msgs_v), _ptr(syn), _ptr(r_c), _ptr(src), _ptr(shift),
        g.node_start, g.count, g.degree, g.block_start, Z, B, pre,
        int(msgs_v.dtype == torch.bfloat16), _stream(msgs_v))
    _check(lib, err, "check-node kernel")
    launch_counts["cn"] += 1


def vn_group(r_c, llr, msgs_v, bits, fresh, src, shift, g, Z: int, B: int,
             pre: float) -> None:
    """Variable-node kernel for one variable-degree group ``g``; ``bits``
    and ``fresh`` may be None."""
    lib = load()
    err = lib.ldpc_vn_group(
        _ptr(r_c), _ptr(llr), _ptr(msgs_v), _ptr(bits), _ptr(fresh),
        _ptr(src), _ptr(shift), g.node_start, g.count, g.degree,
        g.block_start, Z, B, pre, int(r_c.dtype == torch.bfloat16),
        _stream(r_c))
    _check(lib, err, "variable-node kernel")
    launch_counts["vn"] += 1


def parity_group(bits, syn, flags, src, shift, g, Z: int, B: int) -> None:
    """Parity kernel for one check-degree group ``g``: flags [B] int32."""
    lib = load()
    err = lib.ldpc_parity_group(
        _ptr(bits), _ptr(syn), _ptr(flags), _ptr(src), _ptr(shift),
        g.node_start, g.count, g.degree, g.block_start, Z, B, _stream(bits))
    _check(lib, err, "parity kernel")
    launch_counts["parity"] += 1
