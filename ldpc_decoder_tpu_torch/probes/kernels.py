"""The two probe kernels of ``csrc/probes.cu``: wrappers and plain versions.

- :func:`row_copy` (rows 12, 13 and 15 of PERF.md's kernel table): out row
  r = src row idx(r), idx from a (block, shift) table, out[j, z] =
  src[blocks[j], (z + shifts[j]) mod Z] on src [NB, Z, W], or from an int32
  or int64 index, out[r] = src[index[r]] on src [N, W]. Each thread moves
  ``bytes_per_thread`` contiguous bytes.
- :func:`window_stream` (rows 14 and 16): output node i reads D windows
  w_s = src[blocks[i*D+s], (z + shifts[i*D+s]) mod Z] of src [NB, Z, W] in
  float32, aligned, direct or staged through shared memory, and writes
  either their sum from left to right followed by K steps
  (``out="sum"``), or the check-node leave-one-out with the sign algebra
  of ``scripts/micro_overlap6.py:86-100`` (``out="loo"``, one step per
  output). A step is φ_abs(|v| + 0.125) (``phi_live``) or v + 0.125 (φ
  stubbed).

Each has a plain PyTorch version (``*_plain``) computing the same function
in the same order. The wrappers dispatch on the tensors' device: CPU
tensors take the plain version (the CPU tests' path); CUDA tensors launch
the kernel or raise. Shifts must lie in [0, Z) and indices in range: the
kernels trust them, as the decode kernels trust their tables.
"""

from __future__ import annotations

import torch

from ldpc_decoder_tpu_torch.ops import _kernels
from ldpc_decoder_tpu_torch.ops._dispatch import backend
from ldpc_decoder_tpu_torch.ops.phi import PRE_THRESHOLD, phi_abs
from ldpc_decoder_tpu_torch.ops.qc_grouped import _rotated

BYTES_PER_THREAD = (1, 2, 4, 8, 16)
MODES = {"aligned": 0, "direct": 1, "staged": 2}
OUTS = {"sum": 0, "loo": 1}
STAGE_ROWS = 32  # csrc/probes.cu kStageRows: a staged Z is a multiple
# (degree, k) instantiated in csrc/probes.cu, per output
WINDOW_SHAPES = {"sum": {(d, k) for d in (1, 2, 6) for k in (0, 1, 2, 4)},
                 "loo": {(6, 1)}}
_SIGN = -(1 << 31)  # the float32 sign bit as an int32


def _backend(*tensors) -> str:
    """"cpu" (plain version) or "cuda" (kernel, contiguous tensors);
    raises otherwise. None stands for an absent tensor."""
    present = [t for t in tensors if t is not None]
    return backend(present[0].device, 0, 0, *present)


def _check_table(blocks, shifts, n: int) -> None:
    for t, name in ((blocks, "blocks"), (shifts, "shifts")):
        if t.dtype != torch.int32 or t.shape != (n,):
            raise ValueError(f"{name} must be int32 [{n}], got {t.dtype} "
                             f"{tuple(t.shape)}")


# ---- row copy ---------------------------------------------------------------

def row_copy_plain(src, blocks=None, shifts=None, index=None) -> torch.Tensor:
    """Plain PyTorch row copy: ``_rotated`` for a table, indexing for an
    index."""
    if index is None:
        return _rotated(src, blocks, shifts, src.shape[1])
    return src[index.long()]


def row_copy(src, blocks=None, shifts=None, index=None, out=None,
             bytes_per_thread: int = 16) -> torch.Tensor:
    """Table mode: src [NB, Z, W], blocks and shifts int32 [n] -> out
    [n, Z, W]. Index mode: src [N, W], index int32 or int64 [n] -> out
    [n, W]. ``out`` (optional) is written in place; returns it."""
    if (index is None) == (blocks is None):
        raise ValueError("give either blocks and shifts, or an index")
    if index is None:
        if src.dim() != 3:
            raise ValueError("table mode copies rows of src [NB, Z, W]")
        _check_table(blocks, shifts, blocks.numel())
        shape = (blocks.numel(), *src.shape[1:])
    else:
        if src.dim() != 2 or index.dim() != 1 or index.dtype not in (
                torch.int32, torch.int64):
            raise ValueError("index mode copies rows of src [N, W] by an "
                             "int32 or int64 index [n]")
        shape = (index.numel(), src.shape[1])
    if out is None:
        out = torch.empty(shape, dtype=src.dtype, device=src.device)
    if tuple(out.shape) != shape or out.dtype != src.dtype:
        raise ValueError(f"out must be {src.dtype} {shape}")
    if _backend(src, out, blocks, shifts, index) == "cpu":
        return out.copy_(row_copy_plain(src, blocks, shifts, index))
    row_bytes = src.shape[-1] * src.element_size()
    if bytes_per_thread not in BYTES_PER_THREAD or row_bytes % \
            bytes_per_thread:
        raise ValueError(f"bytes_per_thread {bytes_per_thread} must be one "
                         f"of {BYTES_PER_THREAD} and divide the row's "
                         f"{row_bytes} bytes")
    if src.data_ptr() % bytes_per_thread or out.data_ptr() % bytes_per_thread:
        raise ValueError("src and out must be aligned to bytes_per_thread")
    n_rows = out.numel() // src.shape[-1]
    Z = src.shape[1] if index is None else 0
    with torch.cuda.device(src.device):
        _kernels.probe_row_copy(src, out, blocks, shifts, index, n_rows, Z,
                                row_bytes, bytes_per_thread)
    return out


# ---- window stream ----------------------------------------------------------

def _step(v: torch.Tensor, phi_live: bool) -> torch.Tensor:
    return phi_abs(v.abs() + 0.125) if phi_live else v + 0.125


def window_stream_plain(src, blocks, shifts, degree: int, k: int = 0,
                        out: str = "sum", phi_live: bool = True,
                        syn=None) -> torch.Tensor:
    """Plain PyTorch window stream (the counterpart of the kernel, every
    mode): float32 windows, the sum from 0 left to right, then ``k``
    steps; or the leave-one-out ext − a_s with the sign algebra."""
    Z, W = src.shape[1], src.shape[2]
    n = blocks.numel() // degree
    w = _rotated(src, blocks, shifts, Z).to(torch.float32).view(
        n, degree, Z, W)
    if out == "sum":
        v = torch.zeros((n, Z, W), dtype=torch.float32, device=src.device)
        for s in range(degree):  # left to right, as the kernel sums
            v = v + w[:, s]
        for _ in range(k):
            v = _step(v, phi_live)
        return v.to(src.dtype)
    sb = w.view(torch.int32) & _SIGN
    a = w.abs()
    X = (torch.zeros((n, Z, W), dtype=torch.int32, device=src.device)
         if syn is None else syn.to(torch.int32) * _SIGN)
    for s in range(degree):
        X = X ^ sb[:, s]
    ext = a[:, 0]
    for s in range(1, degree):
        ext = ext + a[:, s]
    res = torch.empty((n, degree, Z, W), dtype=torch.float32,
                      device=src.device)
    for s in range(degree):
        mag = _step(ext - a[:, s], phi_live)
        res[:, s] = (mag.view(torch.int32) | (sb[:, s] ^ X)).view(
            torch.float32)
    return res.view(n * degree, Z, W).to(src.dtype)


def window_stream(src, blocks, shifts, degree: int, k: int = 0,
                  mode: str = "direct", out: str = "sum",
                  phi_live: bool = True, syn=None, result=None,
                  rows: int = 8) -> torch.Tensor:
    """src [NB, Z, W] (bfloat16 on the card), blocks and shifts int32
    [n * degree], syn int8 [n, Z, W] or None (``out="loo"`` only) -> [n, Z,
    W] (sum) or [n * degree, Z, W] (leave-one-out), written into
    ``result`` when given; returns it. ``mode``: "aligned", "direct" or
    "staged" (Z a multiple of :data:`STAGE_ROWS`, at least two tiles);
    ``rows``: rows walked per thread (aligned and direct)."""
    if mode not in MODES or out not in OUTS:
        raise ValueError(f"mode must be one of {sorted(MODES)}, out one of "
                         f"{sorted(OUTS)}")
    if (degree, k) not in WINDOW_SHAPES[out]:
        raise ValueError(f"no {out} window kernel for degree {degree}, k {k}:"
                         f" {sorted(WINDOW_SHAPES[out])}")
    if src.dim() != 3 or blocks.numel() % degree:
        raise ValueError("src must be [NB, Z, W] and the table hold degree "
                         "windows per node")
    _check_table(blocks, shifts, blocks.numel())
    n, (_, Z, W) = blocks.numel() // degree, src.shape
    if syn is not None and (out != "loo" or syn.dtype != torch.int8
                            or tuple(syn.shape) != (n, Z, W)):
        raise ValueError(f"syn must be int8 [{n}, {Z}, {W}], leave-one-out "
                         f"only")
    shape = (n, Z, W) if out == "sum" else (n * degree, Z, W)
    if result is None:
        result = torch.empty(shape, dtype=src.dtype, device=src.device)
    if tuple(result.shape) != shape or result.dtype != src.dtype:
        raise ValueError(f"result must be {src.dtype} {shape}")
    if _backend(src, blocks, shifts, syn, result) == "cpu":
        return result.copy_(window_stream_plain(
            src, blocks, shifts, degree, k, out, phi_live, syn))
    if src.dtype != torch.bfloat16:
        raise ValueError("the window kernel is built for bfloat16 only")
    if mode == "staged" and (Z % STAGE_ROWS or Z < 2 * STAGE_ROWS):
        raise ValueError(f"staged mode needs Z a multiple of {STAGE_ROWS}, "
                         f"at least {2 * STAGE_ROWS}; got {Z}")
    if not 1 <= n <= 65535 or not 1 <= rows <= Z:
        raise ValueError(f"{n} nodes (1..65535) or {rows} rows (1..Z)")
    with torch.cuda.device(src.device):
        _kernels.probe_window(src, syn, result, blocks, shifts, degree, k,
                              MODES[mode], OUTS[out], phi_live, rows,
                              PRE_THRESHOLD)
    return result
