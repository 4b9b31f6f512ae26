"""Row 14: does φ's arithmetic hide under memory traffic on the card?

Four TPU scripts asked it of Mosaic; each gets a counterpart here, built on
:func:`~ldpc_decoder_tpu_torch.probes.kernels.window_stream` with the decode
kernels' own φ (``phi_abs`` of ``csrc/common.cuh``). The TPU's "staged"
variants (an f32 VMEM scratch and a dynamic slice of it) become the staged
mode, a tile pair in shared memory; unstaged reads are the aligned mode.
φ's marginal cost is the time with φ live minus the time with φ stubbed (v +
0.125), on the same bytes.

- :func:`overlap2` replaces ``scripts/micro_overlap2.py:52``
  ``make_kernel`` (``pallas_call`` at ``:90``): out = φ^k(x) over [4096,
  1024, 128] bfloat16 for k = 0, 1, 2, 4, staged or not. The script's
  ``cost_estimate`` variant has no counterpart: it is a scheduling hint to
  Mosaic, and nvcc schedules from the code alone.
- :func:`overlap3` replaces ``micro_overlap3.py:41`` ``build``
  (``:63``): the block height H (tiles per grid step) becomes the rows each
  thread walks, 1 to 32, at k = 0; then k = 1, 2, 4 at the fastest; then 2
  and 6 windows reading the same block, as the script's refs did.
- :func:`overlap4` replaces ``micro_overlap4.py:55`` ``build``
  (``:116``), at its 512 steps of [1024, 128]: v0 one window, φ(x); v1 six
  windows, φ(sum); v2 the same staged; v3 staged with per-window offsets
  from a table; v4 plus the six leave-one-out outputs (with the check
  node's sign algebra and no syndrome). Each with φ live and stubbed (the
  script's v5 is v4 stubbed).
- :func:`overlap6` replaces ``micro_overlap6.py:58`` ``build``
  (``:172``), at one p41 degree-6 group (16 nodes, Z = 18,432, B = 256, 176
  source blocks): the leave-one-out with the sign algebra and the syndrome
  XOR of ``:86-100``. w0 the control (aligned, no rotation); w1 the halo's
  counterpart, the ``(z + s) mod Z`` read with shifts below 128 (the TPU
  needed a halo ref to reach past its tile); w2 the rotated read over [NB,
  Z, B] with any shift; w3 w2 with the output recycled, one output tensor
  across the timed calls, where w0 to w2 ask for a fresh one per call
  (PyTorch's caching allocator may hand back the same block). Each with φ
  live and stubbed.

Every window table reads distinct source blocks (a permutation), except
overlap3's same-block windows, so the bytes moved are the unique bytes.
Where the function is a plain copy (one window per block, every block in
order, no shift, k = 0: overlap2's and overlap3's k = 0 points), the
record's ``library_ms`` is ``Tensor.copy_`` of the source into the output,
a yardstick only.
"""

from __future__ import annotations

import torch

from ldpc_decoder_tpu_torch.probes import _common as C
from ldpc_decoder_tpu_torch.probes.kernels import (
    window_stream,
    window_stream_plain,
)
from ldpc_decoder_tpu_torch.runtime import perf

OVERLAP2 = "scripts/micro_overlap2.py:52"
OVERLAP3 = "scripts/micro_overlap3.py:41"
OVERLAP4 = "scripts/micro_overlap4.py:55"
OVERLAP6 = "scripts/micro_overlap6.py:58"


def _check(res, ref, exact: bool, what: str) -> float:
    if exact:
        return C.assert_bit_equal(res, ref, what)
    return C.assert_msgs_match(res, ref, what)


def _is_copy(src, blocks, shifts, degree: int, k: int, out: str) -> bool:
    """Whether the window stream computes a plain copy of ``src``."""
    return (out == "sum" and degree == 1 and k == 0
            and blocks.numel() == src.shape[0]
            and torch.equal(blocks.cpu(), torch.arange(blocks.numel(),
                                                       dtype=blocks.dtype))
            and not bool(shifts.any()))


def measure(probe: str, replaces: str, params: dict, dev, card, src, blocks,
            shifts, degree: int, k: int, mode: str, out: str = "sum",
            phi_live: bool = True, syn=None, rows: int = 8,
            recycle: bool = True, plain: bool = False) -> dict:
    """One window-stream configuration: the kernel held against its plain
    version (bit-exact with φ stubbed or k = 0, else the compare_msgs
    rule), timed, and recorded with its unique bytes and operations, and
    with the time of ``Tensor.copy_`` where the function is a copy.
    ``recycle``: time into one output tensor (else a fresh one per call);
    ``plain``: time the plain version too."""
    kw = dict(degree=degree, k=k, out=out, phi_live=phi_live, syn=syn)
    res = window_stream(src, blocks, shifts, mode=mode, rows=rows, **kw)
    ref = window_stream_plain(src, blocks, shifts, **kw)
    err = _check(res, ref, not phi_live or k == 0,
                 f"{probe} {params} {mode} {out} k={k} live={phi_live}")
    del ref
    n, (_, Z, W) = blocks.numel() // degree, src.shape
    elems = n * Z * W
    n_src = torch.unique(blocks).numel()
    n_bytes = (n_src * Z * W + res.numel()) * src.element_size() \
        + 8 * blocks.numel() + (0 if syn is None else syn.numel())
    step = perf.OPS_PER_MESSAGE if phi_live else 1
    n_ops = (elems * (degree + k * step) if out == "sum"
             else elems * degree * (5 + step))
    target = res if recycle else None
    ms = C.timed(dev, lambda: window_stream(src, blocks, shifts, mode=mode,
                                            rows=rows, result=target, **kw))
    plain_ms = C.timed(dev, lambda: window_stream_plain(
        src, blocks, shifts, **kw), reps=3) if plain else None
    library_ms = None
    if _is_copy(src, blocks, shifts, degree, k, out):
        C.assert_bit_equal(res, src, f"{probe} {params} {mode}: the copy")
        library_ms = C.timed(dev, lambda: res.copy_(src))
    return C.record(probe, replaces,
                    {**params, "degree": degree, "k": k, "mode": mode,
                     "out": out, "phi": None if k == 0 and out == "sum"
                     else "live" if phi_live else "stub",
                     "rows_per_thread": rows if mode != "staged" else None,
                     "recycled_output": recycle},
                    n_bytes, n_ops, card, ms=ms, library_ms=library_ms,
                    plain_ms=plain_ms, max_abs_err=err)


def _sizes(small: bool):
    """(blocks, rows per block, lanes) of the streaming scripts."""
    return (16, 64, 128) if small else (4096, 1024, 128)


def overlap2(dev: torch.device, small: bool = False, headline: bool = False,
             card: dict | None = None) -> list[dict]:
    """φ^k over one window per block, unstaged then staged (headline:
    unstaged, k = 1)."""
    card = card or C.card(dev)
    N, T, LB = _sizes(small)
    x = C.randn((N, T, LB), torch.bfloat16, dev, seed=21, offset=1.5)
    ident = torch.arange(N, device=dev, dtype=torch.int32)
    zero = torch.zeros_like(ident)
    records = []
    for staged in (False, True):
        prev = None
        for k in (1,) if headline else (0, 1, 2, 4):
            r = measure("overlap2", OVERLAP2, {"blocks": N, "T": T, "LB": LB},
                        dev, card, x, ident, zero, 1, k,
                        "staged" if staged else "aligned", plain=headline)
            r["delta_ms"] = (None if prev is None or r["ms"] is None
                             else r["ms"] - prev)
            prev = r["ms"]
            records.append(r)
        if headline:
            break
    return records


def overlap3(dev: torch.device, small: bool = False, headline: bool = False,
             card: dict | None = None) -> list[dict]:
    """Rows per thread at k = 0, then k and same-block windows at the
    fastest (headline: 8 rows, k = 0)."""
    card = card or C.card(dev)
    N, T, LB = _sizes(small)
    x = C.randn((N, T, LB), torch.bfloat16, dev, seed=31, offset=1.5)
    ident = torch.arange(N, device=dev, dtype=torch.int32)
    params = {"blocks": N, "T": T, "LB": LB}

    def one(rows, k=0, degree=1):
        blocks = ident.repeat_interleave(degree)  # windows share a block
        return measure("overlap3", OVERLAP3, params, dev, card, x, blocks,
                       torch.zeros_like(blocks), degree, k, "aligned",
                       rows=rows, plain=headline)

    if headline:
        return [one(8)]
    records = [one(rows) for rows in (1, 2, 4, 8, 16, 32)]
    timed = [r for r in records if r["ms"] is not None]
    best = (min(timed, key=lambda r: r["ms"]) if timed else records[3])
    rows = best["params"]["rows_per_thread"]
    records += [one(rows, k=k) for k in (1, 2, 4)]
    records += [one(rows, degree=d) for d in (2, 6)]
    return records


def overlap4(dev: torch.device, small: bool = False, headline: bool = False,
             card: dict | None = None) -> list[dict]:
    """v0-v4, φ stubbed then live, with φ's marginal on the live record
    (headline: v4)."""
    card = card or C.card(dev)
    steps, T, LB = (8, 64, 128) if small else (512, 1024, 128)
    D = 6
    x1 = C.randn((steps, T, LB), torch.bfloat16, dev, seed=41, offset=1.5)
    x6 = C.randn((steps * D, T, LB), torch.bfloat16, dev, seed=42, offset=1.5)
    ident = torch.arange(steps, device=dev, dtype=torch.int32)
    perm = C.permutation(steps * D, dev, seed=43)
    fine = C.integers(steps * D, T, dev, seed=44)
    zero = torch.zeros_like(perm)
    variants = {
        0: (x1, ident, torch.zeros_like(ident), 1, "aligned", "sum"),
        1: (x6, perm, zero, D, "aligned", "sum"),
        2: (x6, perm, zero, D, "staged", "sum"),
        3: (x6, perm, fine, D, "staged", "sum"),
        4: (x6, perm, fine, D, "staged", "loo"),
    }
    records = []
    for v in (4,) if headline else sorted(variants):
        src, blocks, shifts, degree, mode, out = variants[v]
        pair = [measure("overlap4", OVERLAP4,
                        {"variant": f"v{v}", "steps": steps, "T": T,
                         "LB": LB}, dev, card, src, blocks, shifts, degree,
                        1, mode, out, phi_live=live, plain=headline and live)
                for live in (False, True)]
        stub, live = pair
        live["phi_marginal_ms"] = (None if live["ms"] is None
                                   else live["ms"] - stub["ms"])
        records += [live, stub] if headline else pair
    return records


def overlap6(dev: torch.device, small: bool = False, headline: bool = False,
             card: dict | None = None) -> list[dict]:
    """w0-w3 at one p41 degree-6 group, φ stubbed then live, with φ's
    marginal on the live record (headline: w2)."""
    card = card or C.card(dev)
    nodes, Z, B, NB = (2, 256, 128, 16) if small else (16, 18432, 256, 176)
    D = 6
    x = C.randn((NB, Z, B), torch.bfloat16, dev, seed=61, offset=1.5)
    blocks = C.permutation(NB, dev, seed=62)[:nodes * D].contiguous()
    syn = C.randn((nodes, Z, B), torch.int8, dev, seed=63).bitwise_and_(1)
    zero = torch.zeros_like(blocks)
    halo = C.integers(nodes * D, 128, dev, seed=64)
    full = C.integers(nodes * D, Z, dev, seed=65)
    levels = {0: ("aligned", zero, False), 1: ("direct", halo, False),
              2: ("direct", full, False), 3: ("direct", full, True)}
    records = []
    for w in (2,) if headline else sorted(levels):
        mode, shifts, recycle = levels[w]
        pair = [measure("overlap6", OVERLAP6,
                        {"level": f"w{w}", "nodes": nodes, "Z": Z, "B": B,
                         "source_blocks": NB}, dev, card, x, blocks, shifts,
                        D, 1, mode, "loo", phi_live=live, syn=syn,
                        recycle=recycle, plain=headline and live)
                for live in (False, True)]
        stub, live = pair
        live["phi_marginal_ms"] = (None if live["ms"] is None
                                   else live["ms"] - stub["ms"])
        records += [live, stub] if headline else pair
    return records
