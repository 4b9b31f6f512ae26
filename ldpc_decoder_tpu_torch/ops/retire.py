"""Retire: the finished lanes' hard bits packed into natural-order words
and written into the decode's results.

The port's counterpart of the retire pack of
``ldpc_decoder_tpu/runtime/decoder.py:105`` ``_pack_bits_natural`` (which
XLA compiles: it has no Pallas kernel), the analog of the reference's
deinterlace_output (flood.cu:277-295). At the end of a superstep the
decoder hands over the hard bits of its B lanes (``bits`` [*node shape, B]
int8, 0 or 1, in its sorted order, the lane innermost), the lanes that
retire and their pool frames; each such frame's row of ``results``
([n_pool, n_words] int32, the uint32 words' bit patterns) gets the lane's
words: bit j of word w = natural variable 32 w + j, zero past n_vars.
``src_row`` ([n_vars] int32, natural variable -> its sorted row: the
decoder's ``vn_pos``) serves every layout the decoder has, block-aligned
and interleaved QC codes and the general path.

:func:`pack_retired` dispatches on the device: CPU tensors take the plain
version (:func:`pack_retired_plain`: the retiring lanes' columns gathered,
their rows through ``src_row``, then
:func:`~ldpc_decoder_tpu_torch.rng.chacha_torch.pack_rows`); CUDA tensors
launch ``csrc/retire.cu``'s kernel once (:func:`..ops._kernels.retire_pack`,
counted under ``retire_pack``) or raise. There is no fallback. The kernel
reads the retiring lanes as a table of B frame ids (-1 for a lane that
does not retire), which reaches the card in one copy from the pinned buffer
of a :class:`RetireStaging`.
"""

from __future__ import annotations

import numpy as np
import torch

from ldpc_decoder_tpu_torch.ops import _kernels
from ldpc_decoder_tpu_torch.ops._dispatch import backend, check
from ldpc_decoder_tpu_torch.rng.chacha_torch import pack_rows


class RetireStaging:
    """The kernel's lane table on one card: a pinned host buffer of B int32,
    its copy on the card, and the event after the last copy, waited for
    before the host buffer is written again (in a decode the flag read of
    the superstep has already passed it)."""

    def __init__(self, B: int, device):
        self.host = torch.empty(B, dtype=torch.int32, pin_memory=True)
        self.table = torch.empty(B, dtype=torch.int32, device=device)
        self.copied = torch.cuda.Event()

    def upload(self, lanes: np.ndarray,
               frame_ids: np.ndarray) -> torch.Tensor:
        """The table for ``lanes`` retiring into ``frame_ids``, its copy to
        the card queued on the current stream."""
        self.copied.synchronize()  # returns at once before the first copy
        host = self.host.numpy()
        host.fill(-1)
        host[lanes] = frame_ids
        self.table.copy_(self.host, non_blocking=True)
        self.copied.record()
        return self.table


def pack_words(bits: torch.Tensor, src_row: torch.Tensor,
               n_words: int) -> torch.Tensor:
    """Hard bits [*node shape, n] in sorted order -> [n, n_words] int32:
    each lane's words in natural order (the plain version's pack)."""
    return pack_rows(bits.reshape(-1, bits.shape[-1]).index_select(
        0, src_row), n_words)


def pack_retired_plain(bits: torch.Tensor, src_row: torch.Tensor,
                       lanes: np.ndarray, frame_ids: np.ndarray,
                       results: torch.Tensor) -> None:
    """The plain version of :func:`pack_retired`, on any device."""
    dev = bits.device
    cols = bits[..., torch.from_numpy(lanes).to(dev)]
    results[torch.from_numpy(frame_ids).to(dev)] = pack_words(
        cols, src_row, results.shape[1])


def _check_lanes(lanes: np.ndarray, frame_ids: np.ndarray, B: int,
                 n_pool: int) -> None:
    if lanes.shape != frame_ids.shape or lanes.ndim != 1:
        raise ValueError(f"lanes {lanes.shape} and frame_ids "
                         f"{frame_ids.shape} must be 1-D of one length")
    if lanes.size and (lanes.min() < 0 or lanes.max() >= B
                       or frame_ids.min() < 0 or frame_ids.max() >= n_pool):
        raise ValueError(f"lanes must lie in [0, {B}) and frame_ids in "
                         f"[0, {n_pool})")
    if (np.unique(lanes).size != lanes.size
            or np.unique(frame_ids).size != frame_ids.size):
        raise ValueError("lanes and frame_ids must not repeat")


def pack_retired(bits: torch.Tensor, src_row: torch.Tensor, lanes,
                 frame_ids, results: torch.Tensor,
                 staging: RetireStaging | None = None) -> None:
    """Pack the hard bits of lanes ``lanes`` of ``bits`` [*node shape, B]
    into natural-order words and write them into rows ``frame_ids`` of
    ``results`` [n_pool, n_words], in place; no other row is written.
    ``lanes`` and ``frame_ids`` are integer sequences of one length, each
    without repeats. On the card the lane table goes through ``staging``
    (a fresh :class:`RetireStaging` when None)."""
    lanes = np.asarray(lanes, dtype=np.int64)
    frame_ids = np.asarray(frame_ids, dtype=np.int64)
    B = bits.shape[-1]
    n_vars = bits.numel() // B
    n_words = (n_vars + 31) // 32
    check(src_row, "src_row", (n_vars,), (torch.int32,))
    if results.dim() != 2 or results.shape[1] != n_words:
        raise ValueError(f"results must be [n_pool, {n_words}], got "
                         f"{tuple(results.shape)}")
    check(results, "results", tuple(results.shape), (torch.int32,))
    check(bits, "bits", tuple(bits.shape), (torch.int8,))
    _check_lanes(lanes, frame_ids, B, results.shape[0])
    if backend(bits.device, 0, 0, bits, src_row, results) == "cpu":
        pack_retired_plain(bits, src_row, lanes, frame_ids, results)
        return
    with torch.cuda.device(bits.device):
        if staging is None:
            staging = RetireStaging(B, bits.device)
        table = staging.upload(lanes, frame_ids)
        _kernels.retire_pack(bits, src_row, table, results, n_vars, n_words,
                             B)
