"""Frame pools generated where the decoder runs.

The port's counterpart of ``ldpc_decoder_tpu/runtime/datagen_device.py``:
a pool's reference bits, channel values and syndromes are made on the
decoder's device from absolute frame indices (the reference's seeding, see
:mod:`ldpc_decoder_tpu_torch.rng.chacha_torch`), in the layouts
:meth:`LDPCDecoder.decode_presorted` takes, with nothing crossing from the
host. On the card the bits and values come from ``csrc/datagen.cu``'s two
kernels; the syndrome and the error count are plain PyTorch on every device
(a gather and a sum each, run once per pool, as the JAX package leaves them
to XLA).

:func:`create_pool_device` takes the decoder where the JAX function takes
``(cc, tables)``: the port's decoder holds its I/O orders
(``_vn_order_io``, ``_cn_order_io``, with a detected interleaved
renumbering composed in) and its code, whose erased tail
(``n_erased_vars``, :meth:`LDPCDecoder.set_erased_variables`) gets 0.0.
For BSC and erasure the pool equals :meth:`LDPCDecoder.upload_pools` of the
host ``create_data`` batch; for BI-AWGN it equals it in bits, syndromes and
packed reference words (the host draws the reference's polar method, the
pool Box-Muller, as in JAX).
"""

from __future__ import annotations

import weakref
from typing import NamedTuple

import numpy as np
import torch

from ldpc_decoder_tpu_torch.channels.base import Channel
from ldpc_decoder_tpu_torch.rng.chacha_torch import (
    MASK32,
    channel_values,
    reference_bits_packed,
)

# the syndrome's [E, chunk] int32 temporary: at most this many elements
# (1 GiB)
SYNDROME_TEMP_ELEMS = 1 << 28
_NOISE_ATTR = {"bsc": "p", "erasure": "epsilon", "awgn": "sigma"}


class DevicePool(NamedTuple):
    """A decode-ready pool of frames on the decoder's device."""

    values_sorted: torch.Tensor  # [n_vars, N] float32, sorted vn order
    syn_sorted: torch.Tensor     # [n_checks, N] int8, sorted cn order
    ref_packed: torch.Tensor     # [N, n_words] int32 (uint32 bit patterns)


class _PoolTables(NamedTuple):
    """A decoder's index tables for pool generation, on its device."""

    pos: torch.Tensor         # [n_vars] int32, natural -> sorted row
    edge_var: torch.Tensor    # [E] int64, variable of each check-major edge
    edge_check: torch.Tensor  # [E] int64, check of each check-major edge
    cn_order: torch.Tensor    # [n_checks] int64, sorted row -> check


_TABLES: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _pool_tables(dec) -> _PoolTables:
    """The tables of ``dec``, built once per decoder (its orders and edges
    never change; :meth:`set_erased_variables` changes only the tail)."""
    t = _TABLES.get(dec)
    if t is None:
        code, dev = dec.code, dec.device
        pos = np.empty(code.n_vars, dtype=np.int32)
        pos[dec._vn_order_io] = np.arange(code.n_vars, dtype=np.int32)

        def up(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)

        t = _TABLES[dec] = _PoolTables(
            pos=up(pos, np.int32),
            edge_var=up(code.out_edge_to_in_bit, np.int64),
            edge_check=up(code.out_edge_to_bit, np.int64),
            cn_order=up(dec._cn_order_io, np.int64))
    return t


def syndrome_sorted(bits: torch.Tensor, edge_var: torch.Tensor,
                    edge_check: torch.Tensor, cn_order: torch.Tensor,
                    n_checks: int) -> torch.Tensor:
    """[n_checks, n] int8 syndromes in sorted check order of the bits
    [n_vars, n] (natural order): the bits gathered over the code's edges,
    summed per check (``index_add_``), the low bit kept, the rows taken in
    ``cn_order``. One function for every kernel family; the frames are
    chunked so the [E, chunk] int32 temporary stays within
    :data:`SYNDROME_TEMP_ELEMS`."""
    n = bits.shape[1]
    out = torch.empty((n_checks, n), dtype=torch.int8, device=bits.device)
    step = max(1, min(n, SYNDROME_TEMP_ELEMS // max(edge_var.numel(), 1)))
    for lo in range(0, n, step):
        g = bits[:, lo:lo + step].index_select(0, edge_var).to(torch.int32)
        acc = torch.zeros((n_checks, g.shape[1]), dtype=torch.int32,
                          device=bits.device)
        acc.index_add_(0, edge_check, g)
        out[:, lo:lo + step] = (acc & 1).to(torch.int8).index_select(
            0, cn_order)
    return out


def _channel_kind(channel: Channel) -> tuple[str, float]:
    """("bsc", p), ("erasure", epsilon) or ("awgn", sigma); ValueError for
    any other channel."""
    kind = getattr(channel, "channel_type", None)
    if kind not in _NOISE_ATTR:
        raise ValueError(f"unsupported channel {channel!r}")
    return kind, float(getattr(channel, _NOISE_ATTR[kind]))


def create_pool_device(dec, channel: Channel, start_index: int,
                       n_frames: int, batch_index: int = 0,
                       chunk_frames: int = 64) -> DevicePool:
    """Generate the frames ``start_index + batch_index * n_frames`` ..
    ``+ n_frames`` on ``dec``'s device, in its sorted layouts; n_frames a
    multiple of 32. Chunks of ``chunk_frames`` (rounded down to a multiple
    of 32) bound the temporaries; they do not change the pool, since every
    seed is an absolute frame index."""
    if n_frames % 32:
        raise ValueError("on-device generation requires n_frames % 32 == 0")
    kind, noise = _channel_kind(channel)
    code, dev = dec.code, dec.device
    t = _pool_tables(dec)
    n_tx = code.n_vars - code.n_erased_vars
    base = start_index + batch_index * n_frames
    chunk = max(32, (min(chunk_frames, n_frames) // 32) * 32)
    values = torch.empty((code.n_vars, n_frames), dtype=torch.float32,
                         device=dev)
    syn = torch.empty((code.n_checks, n_frames), dtype=torch.int8,
                      device=dev)
    packed = torch.empty((n_frames, dec.n_words), dtype=torch.int32,
                         device=dev)
    for lo in range(0, n_frames, chunk):
        c = min(chunk, n_frames - lo)
        start = (base + lo) & MASK32
        bits, ref = reference_bits_packed(start, code.n_vars, c, dev)
        packed[lo:lo + c] = ref
        channel_values(bits, start, kind, noise, n_tx=n_tx, pos=t.pos,
                       out=values[:, lo:lo + c])
        syn[:, lo:lo + c] = syndrome_sorted(bits, t.edge_var, t.edge_check,
                                            t.cn_order, code.n_checks)
    return DevicePool(values, syn, packed)


def count_bit_errors(results: torch.Tensor,
                     ref_packed: torch.Tensor) -> torch.Tensor:
    """Per-frame bit errors [N] int32 between packed words [N, n_words]
    (int32 holding uint32 patterns, as ``decode_presorted`` returns them
    with ``fetch_results=False``): XOR, a SWAR popcount on int64 masked to
    32 bits, a sum over the words (main.cpp:416-431)."""
    x = (results ^ ref_packed).to(torch.int64) & MASK32
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = ((x * 0x01010101) & MASK32) >> 24
    return x.sum(dim=1, dtype=torch.int32)
