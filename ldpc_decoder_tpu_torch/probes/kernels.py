"""The two probe kernels of ``csrc/probes.cu``: wrappers and plain versions.

- :func:`row_copy` (rows 12, 13 and 15 of PERF.md's kernel table): out row
  r = src row idx(r), idx from a (block, shift) table, out[j, z] =
  src[blocks[j], (z + shifts[j]) mod Z] on src [NB, Z, W], or from an int32
  or int64 index, out[r] = src[index[r]] on src [N, W]. Each thread moves
  ``bytes_per_thread`` contiguous bytes.
- :func:`window_stream` (rows 14 and 16): output node i reads D windows
  w_s = src[blocks[i*D+s], (z + shifts[i*D+s]) mod Z] of src [NB, Z, W] in
  float32, aligned, direct or staged through shared memory by bulk copies,
  and writes either their sum from left to right followed by K steps
  (``out="sum"``), or the check-node leave-one-out with the sign algebra
  of ``scripts/micro_overlap6.py:86-100`` (``out="loo"``, one step per
  output). A step is φ_abs(|v| + 0.125) (``phi_live``; the kernel's φ is
  the accurate one of the plain version, or with ``phi="fast"`` the
  decode's MUFU φ) or v + 0.125 (φ stubbed). Every thread moves 16 bytes
  (:data:`WINDOW_LANES` lanes) per load and store; :func:`window_plan`
  and :func:`stage_runs` mirror the kernels' launch and the staged
  blocks' copies, and are checked against the library before its first
  launch (:func:`library`).

Each has a plain PyTorch version (``*_plain``) computing the same function
in the same order (the window stream's with the accurate φ, whatever the
kernel's policy). The wrappers dispatch on the tensors' device: CPU
tensors take the plain version (the CPU tests' path); CUDA tensors launch
the kernel or raise. Shifts must lie in [0, Z) and indices in range: the
kernels trust them, as the decode kernels trust their tables.
"""

from __future__ import annotations

import ctypes
import itertools

import torch

from ldpc_decoder_tpu_torch.ops import _kernels
from ldpc_decoder_tpu_torch.ops._dispatch import backend
from ldpc_decoder_tpu_torch.ops.phi import PRE_THRESHOLD, phi_abs
from ldpc_decoder_tpu_torch.ops.qc_grouped import _rotated

BYTES_PER_THREAD = (1, 2, 4, 8, 16)
MODES = {"aligned": 0, "direct": 1, "staged": 2}
OUTS = {"sum": 0, "loo": 1}
# (degree, k) instantiated in csrc/probes.cu, per output: on the accurate
# φ (and stubbed), and on the fast φ (live only)
WINDOW_SHAPES = {"sum": {(d, k) for d in (1, 2, 6) for k in (0, 1, 2, 4)},
                 "loo": {(6, 1)}}
FAST_SHAPES = {"sum": {(1, 1)}, "loo": {(6, 1)}}
# the window kernels' launch (csrc/probes.cu; window_plan mirrors it)
WINDOW_LANES = 8           # bfloat16 lanes a thread moves per row: 16 bytes
LANE_THREADS = 128         # aligned and direct: threads a block
STAGE_THREADS = 256        # staged: threads a block
STAGE_RING = 3             # staged sum: windows in flight
STAGE_BLOCK_BYTES = 48 * 1024   # staged rows a block holds, at most
STAGE_WINDOW_BYTES = 16 * 1024  # staged rows of one window, at most
STAGE_MAX_ROWS = 64
MAX_ROW_LANES = 1 << 24
GRID_YZ = 65535            # the grid's y and z, at most
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
    library()
    with torch.cuda.device(src.device):
        _kernels.probe_row_copy(src, out, blocks, shifts, index, n_rows, Z,
                                row_bytes, bytes_per_thread)
    return out


# ---- window stream ----------------------------------------------------------

def stage_count(degree: int, out: str) -> int:
    """Windows a staged block holds at once: all of the leave-one-out's,
    a ring of up to :data:`STAGE_RING` for a sum."""
    return degree if out == "loo" else min(degree, STAGE_RING)


def window_plan(mode: str, degree: int, out: str, Z: int, W: int,
                n_nodes: int, rows: int = 8) -> dict | None:
    """The launch ``csrc/probes.cu`` window_plan makes for a shape, or None
    where no launch takes it: ``block`` (x, y), ``grid`` (x, y, z),
    ``smem`` (dynamic shared bytes: the staged rows), ``stage_rows`` (R,
    rows per staged block) and ``stages`` (windows staged at once); the
    last three 0 for the aligned and direct modes."""
    if (not 1 <= degree <= _kernels.MAX_DEGREES["probes"] or Z < 1
            or not WINDOW_LANES <= W <= MAX_ROW_LANES or W % WINDOW_LANES
            or not 1 <= n_nodes <= GRID_YZ):
        return None
    vectors = W // WINDOW_LANES
    if mode == "staged":
        S = stage_count(degree, out)
        window_bytes = min(STAGE_WINDOW_BYTES, STAGE_BLOCK_BYTES // S)
        R = min(window_bytes // (2 * W), STAGE_MAX_ROWS, Z)
        if R < 1:
            return None
        return dict(block=(STAGE_THREADS, 1), grid=(-(-Z // R), 1, n_nodes),
                    smem=S * R * 2 * W, stage_rows=R, stages=S)
    if not 1 <= rows <= Z:
        return None
    lanes = min(vectors, LANE_THREADS)
    side = LANE_THREADS // lanes
    grid_y = -(-vectors // lanes)
    if grid_y > GRID_YZ:
        return None
    return dict(block=(lanes, side), grid=(-(-Z // (side * rows)), grid_y,
                                           n_nodes),
                smem=0, stage_rows=0, stages=0)


def stage_runs(Z: int, z0: int, n: int, shift: int) -> list[tuple[int, int]]:
    """The (start row, length) runs of src a staged block copies for its
    rows z0 .. z0 + n - 1 of a window with shift ``shift`` in [0, Z): the
    rows (z0 + shift) mod Z onward, split in two where they pass Z."""
    start = (z0 + shift) % Z
    first = min(n, Z - start)
    return [(start, first)] + ([(0, n - first)] if first < n else [])


# shapes the load check compares with the library: the probes' own, the
# card tests', a partial last block, odd widths, the widest staged rows
_PLAN_SHAPES = [(1024, 128, 4096, 8), (18432, 256, 16, 8), (174080, 256, 3, 1),
                (256, 200, 2, 3), (200, 128, 2, 256), (100, 8, 1, 1),
                (7, 4096, 65535, 7), (4096, 8192, 1, 32), (33, 8200, 1, 1),
                (64, 12, 1, 1), (64, 256, 65536, 1)]


def check_library(lib) -> None:
    """Raise RuntimeError unless the library's launch plans and staged
    runs are :func:`window_plan`'s and :func:`stage_runs`'."""
    plan = (ctypes.c_longlong * 8)()
    for mode, out in itertools.product(MODES, OUTS):
        for degree, _ in sorted(WINDOW_SHAPES[out]):
            for Z, W, n, rows in _PLAN_SHAPES:
                want = window_plan(mode, degree, out, Z, W, n, rows)
                err = lib.ldpc_probe_window_plan(MODES[mode], degree,
                                                 OUTS[out], Z, W, n, rows,
                                                 plan)
                got = None if err else dict(
                    block=tuple(plan[0:2]), grid=tuple(plan[2:5]),
                    smem=plan[5], stage_rows=plan[6], stages=plan[7])
                if got != want:
                    raise RuntimeError(
                        f"probes library and window_plan disagree at {mode} "
                        f"{out} d={degree} Z={Z} W={W}: {got} != {want}")
    runs = (ctypes.c_int * 4)()
    for Z, z0, n, shift in ((1024, 0, 32, 0), (1024, 992, 32, 40),
                            (1024, 992, 32, 1023), (100, 96, 4, 3),
                            (100, 64, 36, 50), (5, 0, 5, 4), (1, 0, 1, 0)):
        count = lib.ldpc_probe_stage_runs(Z, z0, n, shift, runs)
        got = [(runs[2 * r], runs[2 * r + 1]) for r in range(count)]
        if got != stage_runs(Z, z0, n, shift):
            raise RuntimeError(f"probes library and stage_runs disagree at "
                               f"Z={Z} z0={z0} n={n} shift={shift}")


_library_checked = False


def library():
    """The probes library (``_kernels.load("probes")``), held to
    :func:`window_plan` and :func:`stage_runs` by :func:`check_library` the
    first time."""
    global _library_checked
    lib = _kernels.load("probes")
    if not _library_checked:
        check_library(lib)
        _library_checked = True
    return lib


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
                  rows: int = 8, phi: str = "accurate") -> torch.Tensor:
    """src [NB, Z, W] (bfloat16 on the card), blocks and shifts int32
    [n * degree], syn int8 [n, Z, W] or None (``out="loo"`` only) -> [n, Z,
    W] (sum) or [n * degree, Z, W] (leave-one-out), written into
    ``result`` when given; returns it. ``mode``: "aligned", "direct" or
    "staged"; ``rows``: rows walked per thread (aligned and direct);
    ``phi``: the kernel's φ policy, "accurate" or "fast" (live φ at
    :data:`FAST_SHAPES` only; the plain version has one φ). On the card W
    must be a multiple of :data:`WINDOW_LANES` and every tensor 16-byte
    aligned."""
    if mode not in MODES or out not in OUTS:
        raise ValueError(f"mode must be one of {sorted(MODES)}, out one of "
                         f"{sorted(OUTS)}")
    if (degree, k) not in WINDOW_SHAPES[out]:
        raise ValueError(f"no {out} window kernel for degree {degree}, k {k}:"
                         f" {sorted(WINDOW_SHAPES[out])}")
    _kernels.check_phi(phi)
    if phi == "fast" and not (phi_live and (degree, k) in FAST_SHAPES[out]):
        raise ValueError(f"the fast φ is instantiated for live φ at "
                         f"{out} {sorted(FAST_SHAPES[out])} only")
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
    if W % WINDOW_LANES:
        raise ValueError(f"W = {W} is not a multiple of the "
                         f"{WINDOW_LANES} lanes a thread moves")
    if any(t is not None and t.data_ptr() % 16 for t in (src, syn, result)):
        raise ValueError("src, syn and result must be 16-byte aligned")
    if window_plan(mode, degree, out, Z, W, n, rows) is None:
        raise ValueError(f"no {mode} window launch takes {n} nodes (1.."
                         f"{GRID_YZ}), {rows} rows per thread (1..Z) or "
                         f"W = {W}")
    library()
    with torch.cuda.device(src.device):
        _kernels.probe_window(src, syn, result, blocks, shifts, degree, k,
                              MODES[mode], OUTS[out], phi_live, phi, rows,
                              PRE_THRESHOLD)
    return result
