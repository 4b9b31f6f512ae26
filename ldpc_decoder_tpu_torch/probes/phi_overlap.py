"""Row 14: does φ's arithmetic hide under memory traffic on the card?

Four TPU scripts asked it of Mosaic; each gets a counterpart here, built on
:func:`~ldpc_decoder_tpu_torch.probes.kernels.window_stream` with the
decode kernels' φ policies (``csrc/sum_product.cuh``): ``PhiAccurate``
(``phi_abs`` of ``csrc/common.cuh``, the plain version's φ, the like-for-like
comparison with the first design's records) and, at the headline shapes,
``PhiFast`` (the MUFU φ every sum-product decode launches). The TPU's
"staged" variants (an f32 VMEM scratch and a dynamic slice of it) become
the staged mode: each block's rows of every window copied into shared
memory by the TMA unit (``cp.async.bulk``) and read from there. Its
question on this card: does staging through shared memory by TMA read as
fast as the direct rotated load? Unstaged reads are the aligned mode. φ's
marginal cost is the time with φ live minus the time with φ stubbed (v +
0.125), on the same bytes, per policy.

- :func:`overlap2` replaces ``scripts/micro_overlap2.py:52``
  ``make_kernel`` (``pallas_call`` at ``:90``): out = φ^k(x) over [4096,
  1024, 128] bfloat16 for k = 0, 1, 2, 4, staged or not, and k = 1 on the
  fast φ too. The script's
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
  script's v5 is v4 stubbed), v0 and v4 live on the fast φ too.
- :func:`overlap6` replaces ``micro_overlap6.py:58`` ``build``
  (``:172``), at one p41 degree-6 group (16 nodes, Z = 18,432, B = 256, 176
  source blocks): the leave-one-out with the sign algebra and the syndrome
  XOR of ``:86-100``. w0 the control (aligned, no rotation); w1 the halo's
  counterpart, the ``(z + s) mod Z`` read with shifts below 128 (the TPU
  needed a halo ref to reach past its tile); w2 the rotated read over [NB,
  Z, B] with any shift; w3 w2 with the output recycled, one output tensor
  across the timed calls, where w0 to w2 ask for a fresh one per call
  (PyTorch's caching allocator may hand back the same block). Each with φ
  live (both policies) and stubbed.

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
    FAST_SHAPES,
    window_stream,
    window_stream_plain,
)
from ldpc_decoder_tpu_torch.runtime import perf

OVERLAP2 = "scripts/micro_overlap2.py:52"
OVERLAP3 = "scripts/micro_overlap3.py:41"
OVERLAP4 = "scripts/micro_overlap4.py:55"
OVERLAP6 = "scripts/micro_overlap6.py:58"


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
            recycle: bool = True, plain: bool = False,
            phi: str = "accurate") -> dict:
    """One window-stream configuration: the kernel held against its plain
    version (bit-exact with φ stubbed or k = 0, else the compare_msgs
    rule, compare_msgs_fast on the fast φ), timed, and recorded with its
    unique bytes and operations, and with the time of ``Tensor.copy_``
    where the function is a copy. Each time is taken by both timers of
    ``_common``: ``ms`` and ``library_ms`` by :func:`~._common.timed`,
    ``queued_ms`` and ``queued_library_ms`` by
    :func:`~._common.queued_timed`. ``recycle``: time into one output tensor
    (else a fresh one per call); ``plain``: time the plain version too;
    ``phi``: the kernel's φ policy."""
    kw = dict(degree=degree, k=k, out=out, phi_live=phi_live, syn=syn)
    res = window_stream(src, blocks, shifts, mode=mode, rows=rows, phi=phi,
                        **kw)
    ref = window_stream_plain(src, blocks, shifts, **kw)
    err = C.window_rule(k, phi_live, phi)(
        res, ref, f"{probe} {params} {mode} {out} k={k} live={phi_live} "
        f"{phi}")
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

    def kernel():
        window_stream(src, blocks, shifts, mode=mode, rows=rows,
                      result=target, phi=phi, **kw)

    ms, queued_ms = C.timed(dev, kernel), C.queued_timed(dev, kernel)
    plain_ms = C.timed(dev, lambda: window_stream_plain(
        src, blocks, shifts, **kw), reps=3) if plain else None
    library_ms = queued_library_ms = None
    if _is_copy(src, blocks, shifts, degree, k, out):
        C.assert_bit_equal(res, src, f"{probe} {params} {mode}: the copy")
        library_ms = C.timed(dev, lambda: res.copy_(src))
        queued_library_ms = C.queued_timed(dev, lambda: res.copy_(src))
    return C.record(probe, replaces,
                    {**params, "degree": degree, "k": k, "mode": mode,
                     "out": out, "phi": None if k == 0 and out == "sum"
                     else phi if phi_live else "stub",
                     "rows_per_thread": rows if mode != "staged" else None,
                     "recycled_output": recycle},
                    n_bytes, n_ops, card, ms=ms, library_ms=library_ms,
                    plain_ms=plain_ms, max_abs_err=err, queued_ms=queued_ms,
                    queued_library_ms=queued_library_ms)


def _marginals(live: dict, stub: dict, fast: dict | None) -> None:
    """φ's marginal cost (live − stubbed ms) on each live record."""
    for r in (live, fast):
        if r is not None:
            r["phi_marginal_ms"] = (None if r["ms"] is None
                                    else r["ms"] - stub["ms"])


def _sizes(small: bool):
    """(blocks, rows per block, lanes) of the streaming scripts."""
    return (16, 64, 128) if small else (4096, 1024, 128)


def overlap2(dev: torch.device, small: bool = False, headline: bool = False,
             card: dict | None = None) -> list[dict]:
    """φ^k over one window per block, unstaged then staged, each followed
    by k = 1 on the fast φ (headline: unstaged, k = 1, accurate then
    fast)."""
    card = card or C.card(dev)
    N, T, LB = _sizes(small)
    x = C.randn((N, T, LB), torch.bfloat16, dev, seed=21, offset=1.5)
    ident = torch.arange(N, device=dev, dtype=torch.int32)
    zero = torch.zeros_like(ident)
    params = {"blocks": N, "T": T, "LB": LB}
    records = []
    for mode in ("aligned",) if headline else ("aligned", "staged"):
        prev = None
        for k in (1,) if headline else (0, 1, 2, 4):
            r = measure("overlap2", OVERLAP2, params, dev, card, x, ident,
                        zero, 1, k, mode, plain=headline)
            r["delta_ms"] = (None if prev is None or r["ms"] is None
                             else r["ms"] - prev)
            prev = r["ms"]
            records.append(r)
        records.append(measure("overlap2", OVERLAP2, params, dev, card, x,
                               ident, zero, 1, 1, mode, phi="fast"))
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
    """v0-v4, φ stubbed then live (v0 and v4 also on the fast φ), with φ's
    marginal on each live record (headline: v4, live first)."""
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

        def one(live, phi="accurate"):
            return measure("overlap4", OVERLAP4,
                           {"variant": f"v{v}", "steps": steps, "T": T,
                            "LB": LB}, dev, card, src, blocks, shifts,
                           degree, 1, mode, out, phi_live=live,
                           plain=headline and live and phi == "accurate",
                           phi=phi)

        stub, live = one(False), one(True)
        fast = one(True, "fast") if (degree, 1) in FAST_SHAPES[out] else None
        _marginals(live, stub, fast)
        records += [live, stub] if headline else [stub, live]
        records += [fast] if fast else []
    return records


def overlap6(dev: torch.device, small: bool = False, headline: bool = False,
             card: dict | None = None) -> list[dict]:
    """w0-w3 at one p41 degree-6 group, φ stubbed, live and live on the
    fast φ, with φ's marginal on each live record (headline: w2, live
    first)."""
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

        def one(live, phi="accurate"):
            return measure("overlap6", OVERLAP6,
                           {"level": f"w{w}", "nodes": nodes, "Z": Z, "B": B,
                            "source_blocks": NB}, dev, card, x, blocks,
                           shifts, D, 1, mode, "loo", phi_live=live, syn=syn,
                           recycle=recycle,
                           plain=headline and live and phi == "accurate",
                           phi=phi)

        stub, live, fast = one(False), one(True), one(True, "fast")
        _marginals(live, stub, fast)
        records += [live, stub, fast] if headline else [stub, live, fast]
    return records
