"""Helpers shared by the probes: timing, inputs, checks, the card and the
JSON record.

A probe times its kernel on the card with CUDA events
(:func:`ldpc_decoder_tpu_torch.runtime.perf.cuda_ms`, the median of ten
runs after one warm-up, as ``chip_smoke.py`` times the decode kernels:
:func:`timed`, each run launched on an idle card, so the host's enqueue of
the call counts). The window probes also take :func:`queued_timed`, after
0.1 s of warm-up runs with each run queued behind a spin of the card, so
the host's enqueue falls outside the events (the record's ``queued_ms``).
On the CPU, where the probes run their plain versions at a small size for
the tests, no time is taken: a CPU number is no device metric, so the
record's times are null there.

The bound is the least time the card could take for the probe's work: the
larger of its unique bytes (each input byte read once, each output byte
written once) over the H100's 3.35 TB/s and its float32 operations over
67 TFLOP/s (:func:`ldpc_decoder_tpu_torch.runtime.perf.bound`, the
decode kernels' bound). A kernel is held to its plain version by the
decode kernels' rules (:func:`~ldpc_decoder_tpu_torch.runtime.perf.
compare_msgs`, on the fast φ :func:`~ldpc_decoder_tpu_torch.runtime.perf.
compare_msgs_fast`, and :func:`~ldpc_decoder_tpu_torch.runtime.perf.
bit_identical`).
"""

from __future__ import annotations

import subprocess
import time

import torch

from ldpc_decoder_tpu_torch.runtime import perf


def card(dev: torch.device) -> dict:
    """The device's name and power limit, as nvidia-smi gives them
    (``--query-gpu=name,power.limit``); ``{"name": "cpu"}`` on the CPU.
    nvidia-smi numbers every card of the host whatever the process sees,
    so the card's line is found by its UUID, and its name must be the one
    torch reports."""
    if dev.type != "cuda":
        return {"name": "cpu", "power_limit": None}
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=uuid,name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    rows = [[part.strip() for part in line.split(",")]
            for line in out.strip().splitlines()]
    uuid = str(torch.cuda.get_device_properties(dev).uuid)
    found = [row for row in rows if row[0].removeprefix("GPU-") == uuid]
    if len(found) != 1:
        raise RuntimeError(f"nvidia-smi lists no card with UUID {uuid}: "
                           f"{out!r}")
    _, name, limit = found[0]
    if name != torch.cuda.get_device_name(dev):
        raise RuntimeError(f"nvidia-smi names card {uuid} {name!r}, torch "
                           f"{torch.cuda.get_device_name(dev)!r}")
    return {"name": name, "power_limit": limit}


def timed(dev: torch.device, fn, reps: int = 10,
          setup=None) -> float | None:
    """:func:`~ldpc_decoder_tpu_torch.runtime.perf.cuda_ms` on the card;
    None on the CPU."""
    return perf.cuda_ms(fn, reps, setup) if dev.type == "cuda" else None


# cycles the card spins (``torch.cuda._sleep``) before each queued run:
# about 1 ms at the H100's 1.98 GHz, longer than any probe's host enqueue
QUEUE_CYCLES = 2_000_000
# seconds of warm-up runs before the queued ones: right after
# ``torch.cuda.empty_cache`` frees tens of GB, the card moves memory slower
# for a while, the kernels and ``Tensor.copy_`` alike (PERF.md)
WARMUP_S = 0.1


def queued_timed(dev: torch.device, fn, reps: int = 10,
                 setup=None) -> float | None:
    """:func:`~ldpc_decoder_tpu_torch.runtime.perf.cuda_ms` on the card,
    after :data:`WARMUP_S` of warm-up runs, with the card kept busy
    (``torch.cuda._sleep``) while the host records the start event and
    enqueues ``fn``, so the time is the device's and not the Python
    wrapper's enqueue, which is longer for a ctypes launch than for
    ``Tensor.copy_``; None on the CPU."""
    if dev.type != "cuda":
        return None
    start = time.perf_counter()
    while time.perf_counter() - start < WARMUP_S:
        if setup is not None:
            setup()
        fn()
        torch.cuda.synchronize()

    def queued():
        if setup is not None:
            setup()
        torch.cuda._sleep(QUEUE_CYCLES)

    return perf.cuda_ms(fn, reps, queued)


def record(probe: str, replaces: str, params: dict, n_bytes: int,
           n_ops: int, dev_card: dict, ms: float | None,
           library_ms: float | None = None, plain_ms: float | None = None,
           max_abs_err: float | None = None, **extra) -> dict:
    """One measurement as the JSON object the entry point prints."""
    b_ms, b_by = perf.bound(n_bytes, n_ops)
    return {"probe": probe, "replaces": replaces, "params": params,
            "ms": ms, "bytes": int(n_bytes),
            "gbps": None if ms is None else n_bytes / ms / 1e6,
            "bound_ms": b_ms, "bound_by": b_by, "plain_ms": plain_ms,
            "library_ms": library_ms, "max_abs_err": max_abs_err,
            **extra, "card": dev_card["name"],
            "power_limit": dev_card["power_limit"]}


def generator(dev: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=dev).manual_seed(seed)


def randn(shape, dtype, dev: torch.device, seed: int,
          offset: float = 0.0) -> torch.Tensor:
    """Standard normal values (plus ``offset``) in ``dtype``, made on the
    device from ``seed``; int8 takes uniform integers in [-127, 127]."""
    g = generator(dev, seed)
    if dtype == torch.int8:
        return torch.randint(-127, 128, shape, generator=g, device=dev,
                             dtype=torch.int8)
    x = torch.randn(shape, generator=g, device=dev, dtype=torch.float32)
    return (x + offset).to(dtype)


def permutation(n: int, dev: torch.device, seed: int) -> torch.Tensor:
    """A random permutation of range(n), int32, on the device."""
    return torch.randperm(n, generator=generator(dev, seed), device=dev,
                          dtype=torch.int64).to(torch.int32)


def integers(n: int, high: int, dev: torch.device, seed: int) -> torch.Tensor:
    """``n`` random int32 in [0, high) on the device."""
    return torch.randint(0, high, (n,), generator=generator(dev, seed),
                         device=dev, dtype=torch.int64).to(torch.int32)


def assert_bit_equal(a: torch.Tensor, b: torch.Tensor, what: str) -> float:
    """The same shape, dtype and bits (±0 and NaN payloads included);
    returns 0.0, the max absolute error."""
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"{what}: {a.shape} {a.dtype} against "
                             f"{b.shape} {b.dtype}")
    if not perf.bit_identical(a, b):
        raise AssertionError(f"{what}: not bit-identical")
    return 0.0


def assert_msgs_match(k: torch.Tensor, p: torch.Tensor, what: str) -> float:
    """Kernel against plain φ outputs by
    :func:`~ldpc_decoder_tpu_torch.runtime.perf.compare_msgs`; returns the
    max absolute difference."""
    return perf.compare_msgs(what, k, p)[0]


def assert_msgs_match_fast(k: torch.Tensor, p: torch.Tensor,
                           what: str) -> float:
    """A fast-φ kernel's outputs against plain ones by
    :func:`~ldpc_decoder_tpu_torch.runtime.perf.compare_msgs_fast`;
    returns the max absolute difference."""
    return perf.compare_msgs_fast(what, k, p)[0]


def window_rule(k: int, phi_live: bool, phi: str):
    """The rule a window-stream output is held to its plain version by:
    bit for bit where no φ runs (k = 0 or φ stubbed), else
    :func:`assert_msgs_match` on the accurate φ and
    :func:`assert_msgs_match_fast` on the fast one."""
    if k == 0 or not phi_live:
        return assert_bit_equal
    return assert_msgs_match_fast if phi == "fast" else assert_msgs_match
