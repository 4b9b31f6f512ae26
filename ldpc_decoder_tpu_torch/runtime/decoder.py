"""Decoder orchestration: batched decode with on-the-fly frame replacement.

Port of ``ldpc_decoder_tpu/runtime/decoder.py``. The decoder picks the
kernel family the way the JAX decoder does (``decoder.py:162-269``):

- a code given without ``qc=`` is searched for circulant structure unless
  ``qc_autodetect=False``: the aligned layout first
  (:func:`..codes.qc.detect_qc_structure`), then, when no variable is
  erased, block-interleaved numberings
  (:func:`..codes.qc.detect_qc_structure_permuted`), whose renumbering is
  composed into the I/O order tables so the user's natural-order arrays
  decode unchanged;
- a QC code with a regular base (one check degree, one variable degree)
  takes the regular family (:mod:`..ops.qc_regular`), float8_e5m2
  messages included, any other base, and every int8 decode, the grouped
  one (:mod:`..ops.qc_grouped`);
- a code without QC structure takes the general path
  (:mod:`..ops.general`), float8_e5m2 messages included (the JAX package
  sends those to its XLA path, ``ops/decode.py``, whose arithmetic the
  general kernels' float8 instantiations keep).

Every family runs sum-product and min-sum and exposes the same init, burst
and superstep functions. A pool of all frames of a run lives on the device
in the decoder's sorted layouts; B = parallel_factor lanes decode in
parallel; every k iterations a superstep checks parity, retires finished
or over-budget lanes (packing their hard decisions into the results: on
the card one kernel launch, :mod:`..ops.retire`) and refills them from the
pool.

The JAX package runs the whole schedule inside one ``lax.while_loop``. Here
it is a host loop, like the reference's own scheduler
(ldpc_decoder_gpu.cu:374-611): the device runs the iterations; after each
superstep the host reads the [B] violated flags — the loop's one
device-to-host read — and keeps the lane bookkeeping (frame ids, iteration
counts, pool position) in numpy. The schedule is the JAX package's exactly,
because per-frame iteration counts depend on it:

- a burst of max(0, first_check − k) plain iterations (no emit, no parity);
- supersteps of k iterations. On the QC paths a refilled lane is reset
  in-kernel on the next superstep's first iteration (the lane-reset
  refill: only llr and syn are reloaded, never the edge arrays), so that
  iteration is a wash. The general path's runner has no reset (as in JAX,
  ``decoder.py:580-612``): a refilled lane's messages are re-initialised at
  once from its new llr (only that lane's columns of msgs_v; r_c is
  rewritten by the next check pass), and every iteration counts;
- done = active & (¬violated | iters_done ≥ max_iter); new frame ids come
  from a cumsum over done; stop when no lane is active and the pool is
  empty.

The JAX runtime passes the fresh-lane flags on every superstep; this one
passes them only when some lane was refilled. Results are identical (an
unflagged lane runs the plain iteration either way, and the grouped
family's degree-1 blocks already hold the init messages of every unchanged
lane), which ``tests/test_torch_decoder.py`` checks against the JAX
decoder.

A superstep has two halves, :meth:`LDPCDecoder._launch` (the k iterations
and the flags' copy to the host, started) and :meth:`LDPCDecoder._finish`
(the flag read, retire and refill), so that one host loop can drive several
replicas in lockstep: :meth:`LDPCDecoder.decode_sharded` deals a pool over
a :class:`..parallel.mesh.BatchMesh` (the JAX decoder's ``decode_sharded``
and ``_mesh_decode_fn``), one replica of the decoder a mesh position, each
on its device and its own streams, and the loop runs while the replicas'
remaining frames sum to more than 0 (the JAX loop's psum);
:func:`..parallel.multiprocess.decode_multiprocess` sums them across
processes too.

Host frames reach the device by one route (:meth:`LDPCDecoder._stage`):
copied into a pinned host buffer, sent on the decoder's copy stream, and
permuted into the sorted layouts there by a row gather. ``decode()`` takes
it for one batch; :meth:`LDPCDecoder.decode_streamed` keeps ``depth``
chunks in flight over it, as the reference's streams do
(ldpc_decoder_gpu.cu:218-273, 464-611): the decode runs in a worker thread
on its own compute stream, and every wait of the decode loop (the clock's
syncs, the flag read, the small index uploads) is scoped to the current
stream, so the copies of the chunks before and after it go on beside it.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import logging
import math
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from functools import partial

import numpy as np
import torch

from ldpc_decoder_tpu_torch.channels.base import Channel
from ldpc_decoder_tpu_torch.codes.code import LDPCCode
from ldpc_decoder_tpu_torch.codes.compiled import CompiledCode, compile_code
from ldpc_decoder_tpu_torch.codes.qc import (
    QCStructure,
    detect_qc_structure,
    detect_qc_structure_permuted,
)
from ldpc_decoder_tpu_torch.ops.general import (
    GeneralTables,
    burst_iterations_general,
    init_messages_general,
    init_variable_messages_general,
    run_iterations_general,
)
from ldpc_decoder_tpu_torch.ops import retire
from ldpc_decoder_tpu_torch.ops.phi import pre_from_infinity_threshold
from ldpc_decoder_tpu_torch.ops.qc_decode import QCDecodeTables, llr_dtype
from ldpc_decoder_tpu_torch.ops.qc_grouped import (
    GroupedQCTables,
    burst_iterations_qc_grouped,
    init_messages_qc_grouped,
    run_iterations_qc_grouped,
)
from ldpc_decoder_tpu_torch.ops.qc_regular import (
    QCRegularTables,
    burst_iterations_qc_regular,
    init_messages_qc_regular,
    run_iterations_qc_regular,
)
from ldpc_decoder_tpu_torch.parallel.mesh import (
    canonical_device,
    deal,
    pad_frames,
    reassemble,
)
from ldpc_decoder_tpu_torch.runtime import tracing
from ldpc_decoder_tpu_torch.runtime.params import DynamicParams, StaticParams

_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "float8_e5m2": torch.float8_e5m2, "int8": torch.int8}
_log = logging.getLogger(__name__)


@dataclass
class DecodeStats:
    """Per-decode iteration statistics (ldpc_decoder_gpu.cu:616-628)."""

    iterations: np.ndarray  # [N] per-frame iteration counts
    total_supersteps: int
    total_iterations: int  # global BP iterations executed
    elapsed_seconds: float
    batch_size: int
    # a streamed chunk (decode_streamed): elapsed_seconds spans its
    # submission to the end of its readback, overlapping other chunks;
    # decode_seconds is its decode clock, and on the card ``events`` holds
    # its CUDA events (upload_start, upload_end on the copy stream,
    # decode_start, decode_end on the compute stream, readback_end)
    decode_seconds: float | None = None
    events: dict | None = None
    # frames loaded into a lane after the first fill, and supersteps
    # launched while some lane held no frame (summed over the replicas of
    # decode_sharded)
    refills: int = 0
    drain_supersteps: int = 0
    # while a profiler records (runtime/tracing.py), on the card: ms on the
    # compute stream from each superstep's flag copy to the next
    # superstep's launch, one per superstep but the last; else None
    turn_ms: list | None = None

    @property
    def min_iter(self) -> int:
        return int(self.iterations.min())

    @property
    def max_iter(self) -> int:
        return int(self.iterations.max())

    @property
    def avg_iter(self) -> float:
        return float(self.iterations.mean())

    @property
    def iter_time_per_vector(self) -> float:
        # reference formula (ldpc_decoder_gpu.cu:628):
        # elapsed / (global iterations * batch)
        denom = self.total_iterations * self.batch_size
        return self.elapsed_seconds / denom if denom else 0.0


def _detect_qc(code: LDPCCode):
    """(structure, perm_v, perm_c) of a code given without ``qc=``, as the
    JAX decoder detects it (``decoder.py:162-193``): the aligned layout,
    then a block-interleaved numbering when no variable is erased; the
    permutations are None for an aligned code. (None, None, None) when the
    code has no QC structure."""
    qc = detect_qc_structure(code)
    if qc is not None:
        _log.info("detected QC structure Z=%d (%dx%d base)", qc.Z,
                  qc.n_base_rows, qc.n_base_cols)
        return qc, None, None
    if code.n_erased_vars == 0:
        res = detect_qc_structure_permuted(code)
        if res is not None:
            qc = res[0]
            _log.info("detected block-interleaved QC structure Z=%d (%dx%d "
                      "base)", qc.Z, qc.n_base_rows, qc.n_base_cols)
            return res
    return None, None, None


def _sync(dev: torch.device) -> None:
    """Wait for the current stream of ``dev``: the decode's own work, not
    the copies that a stream of chunks runs beside it."""
    if dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()


# the name prefix of decode_streamed's worker thread and of the staging
# copy's helper threads
STREAM_THREAD = "ldpc-decode-stream"
# a host array of at least STAGE_SPLIT_BYTES is cast into its pinned buffer
# by STAGE_THREADS threads at once, a block of rows each (np.copyto releases
# the GIL; one thread copies 1 GB in about 0.12 s on the card's host)
STAGE_THREADS = 4
STAGE_SPLIT_BYTES = 1 << 24


def _copy_into(dst: np.ndarray, src: np.ndarray) -> None:
    """``np.copyto(dst, src, casting="unsafe")`` (the cast ``astype``
    makes), split by rows over STAGE_THREADS threads for a large ``dst``;
    the threads are joined before it returns."""
    parts = min(STAGE_THREADS, dst.shape[0])
    if dst.nbytes < STAGE_SPLIT_BYTES or parts < 2:
        np.copyto(dst, src, casting="unsafe")
        return
    rows = np.linspace(0, dst.shape[0], parts + 1).astype(int)
    with ThreadPoolExecutor(parts - 1,
                            thread_name_prefix=STREAM_THREAD) as helpers:
        rest = [helpers.submit(np.copyto, dst[a:b], src[a:b],
                               casting="unsafe")
                for a, b in zip(rows[1:-1], rows[2:])]
        np.copyto(dst[:rows[1]], src[:rows[1]], casting="unsafe")
        for done in rest:
            done.result()


class _Slot:
    """One entry of the pinned staging ring: host buffers for a chunk's
    values, syndromes and results, each grown to the largest chunk seen
    and reused. ``uploaded`` is the event after the last upload from it."""

    def __init__(self):
        self._bufs: dict[str, torch.Tensor] = {}
        self.uploaded: torch.cuda.Event | None = None

    def buffer(self, name: str, shape, dtype: torch.dtype) -> torch.Tensor:
        n = math.prod(shape)
        buf = self._bufs.get(name)
        if buf is None or buf.numel() < n:
            buf = self._bufs[name] = torch.empty(n, dtype=dtype,
                                                 pin_memory=True)
        return buf[:n].view(shape)


@dataclass
class _Lanes:
    """The decode loop's state: B lanes in flight over a pool of frames.
    The tensors live on the decoder's device, the bookkeeping on the host."""

    msgs: tuple
    llr: torch.Tensor       # [*node shape, B], LLR-state dtype
    syn: torch.Tensor       # [*check shape, B] int8
    frame_ids: np.ndarray   # [B] pool frame of each lane
    active: np.ndarray      # [B] bool
    iters_done: np.ndarray  # [B] iterations of the lane's frame so far
    iters_out: np.ndarray   # [n_pool] per-frame iteration counts
    pool_next: int          # next pool frame to load
    results: torch.Tensor   # [n_pool, n_words] int32
    input_is_llr: bool = False  # the pool holds LLRs, not channel values
    fresh: torch.Tensor | None = None  # lanes refilled since the last step
    # between the halves of a superstep (_launch, _finish): the last
    # iteration's hard bits, and the [B] violated flags (on the card a pinned
    # host buffer, ready when ``flags_ready`` is)
    bits: torch.Tensor | None = None
    flags: torch.Tensor | None = None
    flags_ready: torch.cuda.Event | None = None
    # DecodeStats' counters, and while tracing the turns' timing events:
    # (after a flag copy, at the next launch) pairs, and the last flag
    # copy's event until its pair is recorded
    refills: int = 0
    drain_supersteps: int = 0
    turns: list | None = None
    turn_start: torch.cuda.Event | None = None
    # on the card, the retire kernel's lane table (pinned, then one copy)
    retire_table: retire.RetireStaging | None = None

    @property
    def n_remaining(self) -> int:
        """Frames not yet retired: active lanes plus the pool's rest."""
        return int(self.active.sum()) + (self.iters_out.size
                                         - self.pool_next)

    def turn_ms(self) -> list | None:
        """The turns' milliseconds, once the stream has been waited for;
        None when no turn was timed."""
        if self.turns is None:
            return None
        return [a.elapsed_time(b) for a, b in self.turns]


def _as_bits(x: torch.Tensor) -> torch.Tensor:
    """``x`` viewed as the integer dtype of its width: a lane-indexed write
    then copies stored bits, for every message dtype on every device."""
    if not x.dtype.is_floating_point:
        return x
    return x.view({1: torch.uint8, 2: torch.int16, 4: torch.int32}[
        x.element_size()])


def _on_device(x, device: torch.device):
    """A tensor, a tuple of tensors or a dataclass of tables, its tensors
    moved to ``device`` (None stays None)."""
    if x is None or isinstance(x, torch.Tensor):
        return None if x is None else x.to(device)
    if isinstance(x, tuple):
        return tuple(_on_device(v, device) for v in x)
    return dataclasses.replace(x, **{
        f.name: getattr(x, f.name).to(device) for f in dataclasses.fields(x)
        if isinstance(getattr(x, f.name), torch.Tensor)})


def _inverse(perm: np.ndarray) -> np.ndarray:
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size, dtype=perm.dtype)
    return inv


class LDPCDecoder:
    """Batched syndrome BP decoder for one code + channel.

    Public surface mirrors the JAX package's (and the reference's,
    h/ldpc_decoder_gpu_cuda.h:108-132): ``parallel_factor()`` and
    ``decode(dyn_params, n_vecs, values, syndromes)``. ``device`` defaults
    to the CUDA card and raises without one; ``device="cpu"`` runs the
    plain passes on the CPU.

    ``qc`` (a QCStructure) selects the QC kernels; without it the code is
    searched for QC structure (``StaticParams.qc_autodetect``, on by
    default) and takes the general path when it has none. Sum-product and
    min-sum run on every family, in float32, bfloat16 and float8_e5m2; int8
    messages take the grouped QC family or the general path.
    ``detect_seconds`` is the detection's time.
    """

    def __init__(self, code: LDPCCode | CompiledCode, channel: Channel,
                 static_params: StaticParams | None = None,
                 device: torch.device | str | None = None,
                 qc: QCStructure | None = None):
        self.params = static_params or StaticParams()
        p = self.params
        cc = code if isinstance(code, CompiledCode) else None
        self.code = cc.code if cc is not None else code
        self.channel = channel
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "LDPCDecoder found no CUDA device: pass device='cpu' to "
                    "run the plain passes on the CPU")
            device = "cuda"
        self.device = torch.device(device)
        self.msg_dtype = _TORCH_DTYPES[p.message_dtype]
        self._llr_dtype = llr_dtype(self.msg_dtype)
        self.n_words = (self.code.n_vars + 31) // 32
        perm_v = perm_c = None
        self.detect_seconds = 0.0
        if qc is None and p.qc_autodetect:
            t0 = time.perf_counter()
            qc, perm_v, perm_c = _detect_qc(self.code)
            self.detect_seconds = time.perf_counter() - t0
        self.qc = qc
        # min-sum arguments of init, burst and superstep (_bind_alg of the
        # JAX decoder); sum-product takes the functions' defaults
        self._alg = {}
        if p.algorithm == "min-sum":
            self._alg = dict(alg=p.algorithm, beta=p.minsum_offset,
                             clamp=p.minsum_clamp, alpha=p.minsum_alpha,
                             qscale=p.minsum_qscale)
        # the general runner re-initialises refilled lanes at once; the QC
        # runners reset them in-kernel (the ``fresh`` flags)
        self._lane_reset = qc is not None
        if qc is None:
            self._init_general(cc or compile_code(self.code))
        else:
            self._init_qc(qc, perm_v, perm_c)
        # the I/O orders as gather indices on the device (_stage)
        self._io_orders = tuple(torch.from_numpy(o).to(self.device)
                                for o in (self._vn_order_io,
                                          self._cn_order_io))
        self._streams = None  # copy, compute, readback (_cuda_streams)
        # decode_sharded's replicas, by (device, index among the mesh
        # positions on that device)
        self._replicas: dict[tuple[torch.device, int], LDPCDecoder] = {}
        self._parallel_factor = self._choose_parallel_factor()

    def _init_qc(self, qc: QCStructure, perm_v=None, perm_c=None) -> None:
        code = self.code
        qct = QCDecodeTables.from_structure(qc, code.n_erased_vars,
                                            self.device)
        if (qct.n_vars != code.n_vars or qct.n_checks != code.n_checks
                or qct.n_edges != code.n_edges):
            raise ValueError("QC structure does not match the code")
        if perm_v is not None:
            # an interleaved numbering: "natural" stays the user's
            # numbering in the I/O order tables (user variable u is aligned
            # variable perm_v[u]), the kernels see the aligned sorted space
            dev = qct.vn_pos.device
            qct = dataclasses.replace(
                qct,
                vn_order=torch.from_numpy(
                    _inverse(perm_v)[qct.vn_order.cpu().numpy()]).to(dev),
                vn_pos=qct.vn_pos[torch.from_numpy(perm_v).to(dev).long()],
                cn_order=torch.from_numpy(
                    _inverse(perm_c)[qct.cn_order.cpu().numpy()]).to(dev))
        regular = len(qct.row_groups) == 1 and len(qct.col_groups) == 1
        # int8 fixed-point min-sum lives in the grouped kernels (a regular
        # base is their one-group special case), as in the JAX decoder;
        # float8_e5m2 keeps the regular family (decoder.py:227-235)
        if regular and self.msg_dtype != torch.int8:
            self.tables = QCRegularTables.from_qc_tables(qct)
            init, run, burst = (init_messages_qc_regular,
                                run_iterations_qc_regular,
                                burst_iterations_qc_regular)
        else:
            self.tables = GroupedQCTables.from_qc_tables(qct)
            init, run, burst = (init_messages_qc_grouped,
                                run_iterations_qc_grouped,
                                burst_iterations_qc_grouped)
        init_kw = {k: v for k, v in self._alg.items()
                   if k in ("alg", "clamp", "qscale")}
        self._init_messages = partial(init, **init_kw)
        self._run_iterations = partial(run, **self._alg)
        self._run_burst = partial(burst, **self._alg)
        Z = qct.Z
        self._node_shape = ((qct.n_vars // Z, Z), (qct.n_checks // Z, Z))
        # the retire's rows: user variable u sits at sorted row vn_pos[u]
        self._src_row = qct.vn_pos.to(self.device, torch.int32)
        self._vn_order_io = qct.vn_order.cpu().numpy()
        self._cn_order_io = qct.cn_order.cpu().numpy()

    def _init_general(self, cc: CompiledCode) -> None:
        t = self.tables = GeneralTables.from_compiled(cc, self.device)
        init_kw = {k: v for k, v in self._alg.items()
                   if k in ("alg", "clamp", "qscale")}
        self._init_messages = partial(init_messages_general, **init_kw)
        self._init_lanes = partial(init_variable_messages_general, **init_kw)
        self._run_iterations = partial(run_iterations_general, **self._alg)
        self._run_burst = partial(burst_iterations_general, **self._alg)
        self._node_shape = ((t.n_vars,), (t.n_checks,))
        self._src_row = t.vn_pos.to(torch.int32)
        self._vn_order_io = t.vn_order.cpu().numpy()
        self._cn_order_io = t.cn_order.cpu().numpy()

    def _pack(self, bits: torch.Tensor) -> torch.Tensor:
        """Hard bits [*node shape, n] in sorted order -> [n, n_words] int32
        words in natural per-frame order, every layout through the rows
        ``_src_row``: the retire of a CPU decode
        (:func:`..ops.retire.pack_words`; the card's is one kernel,
        :func:`..ops.retire.pack_retired`)."""
        return retire.pack_words(bits, self._src_row, self.n_words)

    # ------------------------------------------------------------------
    def _device_memory(self) -> int:
        if self.params.device_memory_bytes is not None:
            return self.params.device_memory_bytes
        if self.device.type == "cuda":
            return torch.cuda.mem_get_info(self.device)[1]
        raise ValueError(
            f"no device memory size for {self.device}: set "
            f"StaticParams.device_memory_bytes or parallel_factor_user")

    def _choose_parallel_factor(self) -> int:
        """Largest power-of-two lane count fitting device memory, capped by
        the user's -p (reference memory model, ldpc_decoder_gpu.cu:72-99);
        StaticParams.parallel_factor_user bypasses the model.

        Per lane: msgs_v and r_c in the message dtype, node-sized state and
        temporaries in float32, syndrome bytes; on the general path also
        the parity check's gathered int8 bits (one byte per edge); per pool
        frame (loading factor 4 assumed): raw values, syndromes and packed
        results."""
        if self.params.parallel_factor_user is not None:
            return int(self.params.parallel_factor_user)
        msg_bytes = torch.empty((), dtype=self.msg_dtype).element_size()
        e, nv, nc = self.code.n_edges, self.code.n_vars, self.code.n_checks
        per_lane = 2 * e * msg_bytes + 3 * nv * 4 + nc
        if not self._lane_reset:  # the general path
            per_lane += e
        per_pool_frame = nv * 4 + nc + nv // 8
        table_bytes = 3 * e * 4 + 2 * nv * 4 + 2 * nc * 4
        budget = (self._device_memory() * (1.0 - self.params.memory_headroom)
                  - table_bytes)
        max_lanes = max(1, int(budget // (per_lane + 4 * per_pool_frame)))
        log_pf = min(int(math.floor(math.log2(max_lanes))),
                     self.params.max_log_parallel_factor_user)
        return 1 << max(log_pf, 0)

    def parallel_factor(self) -> int:
        return self._parallel_factor

    def set_erased_variables(self, n_erased_inputs: int) -> None:
        """Mark the trailing ``n_erased_inputs`` variables (natural order)
        as erased, punctured: their channel LLRs are zeroed at every load
        and refill, and pools generated for this decoder zero their values
        (the reference's setter, h/ldpc_decoder_gpu.h:122-125; JAX
        ``decoder.py:433-450``)."""
        n_vars = self.code.n_vars
        if not 0 <= n_erased_inputs <= n_vars:
            raise ValueError(f"n_erased_inputs {n_erased_inputs} outside "
                             f"[0, {n_vars}]")
        erased_nat = np.zeros(n_vars, dtype=bool)
        erased_nat[n_vars - n_erased_inputs:] = True
        mask = torch.from_numpy(erased_nat[self._vn_order_io])[:, None]
        self.tables = dataclasses.replace(
            self.tables, erased_mask_sorted=mask.to(self.device))
        self._replicas = {}  # they hold the old tables
        self.code = dataclasses.replace(
            self.code, n_erased_vars=int(n_erased_inputs))

    def decoding_input_is_llr(self) -> bool:
        """Raw channel values are expected: every built-in channel converts
        them to LLRs on the device (h/ldpc_decoder_gpu_cuda.h:118-122).
        LLRs computed elsewhere go through ``input_is_llr=True``."""
        return False

    # ------------------------------------------------------------------
    def _lane_llr(self, vals: torch.Tensor, input_is_llr: bool = False):
        """Pool values [n_vars, n] -> LLR state [*node shape, n] in the
        kernels' consumption dtype (the message dtype; bfloat16 for int8
        messages), erased rows zeroed. ``input_is_llr``: the values are
        LLRs already and skip the channel's conversion."""
        llr = vals if input_is_llr else self.channel.llr_from_channel(vals)
        llr = llr.masked_fill(self.tables.erased_mask_sorted, 0.0)
        return llr.to(self._llr_dtype).view(*self._node_shape[0], -1)

    def decode(
        self,
        dyn_params: DynamicParams,
        n_vecs: int,
        values: np.ndarray,      # [n_vars, n_vecs] float32, natural order
        syndromes: np.ndarray,   # [n_checks, n_vecs] 0/1, natural order
        input_is_llr: bool = False,
        host_poll: bool = False,
        progress=None,
    ) -> tuple[np.ndarray, DecodeStats]:
        """Decode ``n_vecs`` frames; returns (packed bits [n_vecs, n_words]
        uint32 in natural per-frame layout, stats). ``values[i, v]`` is the
        i-th channel value of frame v (h/ldpc_decoder_gpu.h:94 transposed),
        or its LLR with ``input_is_llr``. The pools are uploaded in sorted
        layouts before the timed region. The arguments are the JAX
        decoder's, in its order; ``host_poll`` and ``progress`` as in
        :meth:`decode_presorted`."""
        if values.shape != (self.code.n_vars, n_vecs):
            raise ValueError(f"values must be [{self.code.n_vars}, {n_vecs}]")
        if syndromes.shape != (self.code.n_checks, n_vecs):
            raise ValueError(
                f"syndromes must be [{self.code.n_checks}, {n_vecs}]")
        pool_values, pool_syn = self.upload_pools(values, syndromes)
        return self.decode_presorted(dyn_params, n_vecs, pool_values,
                                     pool_syn, host_poll=host_poll,
                                     progress=progress,
                                     input_is_llr=input_is_llr)

    def decode_streamed(
        self,
        dyn_params: DynamicParams,
        chunks,  # iterable of (values [n_vars, n], syndromes [n_checks, n])
        input_is_llr: bool = False,
        depth: int = 2,
    ):
        """Host-fed pipeline over an iterable of natural-order frame chunks
        (the JAX decoder's ``decode_streamed``, in its arguments and
        yields): yields ``(results, stats)`` per chunk, in order, each
        bit-identical to a ``decode()`` of that chunk, ``results`` uint32
        [n, n_words] in natural per-frame layout, a fresh array.

        Up to ``depth`` chunks are in flight: the next chunk is taken from
        the iterator, staged (:meth:`_stage`, through a ring of ``depth``
        pinned slots) and uploaded while a worker thread decodes the one
        before it on its own compute stream, and a finished chunk's results
        come back on a readback stream into its slot's pinned buffer. Chunk
        i is yielded once its readback is done, and not before chunk
        i + depth - 1 has been taken from the iterator (or the iterator is
        exhausted); ``depth`` = 1 runs the chunks strictly in turn. On the
        CPU the same pipeline runs without pinning and streams.

        ``stats.elapsed_seconds`` spans the chunk's submission to the end
        of its readback, and these spans OVERLAP: for throughput divide
        the stream's bits by its wall time. ``stats.decode_seconds`` is
        the chunk's decode clock, ``stats.events`` its CUDA events.

        A bad chunk shape raises ValueError; an exception of the iterator
        or of the worker reaches the caller; closing the generator (or
        leaving the loop) joins the worker. One stream at a time per
        decoder: a stream and ``decode()`` share the copy stream."""
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        ring = [_Slot() for _ in range(depth)]
        streams = (self._cuda_streams() if self.device.type == "cuda"
                   else None)
        inflight: deque = deque()
        worker = ThreadPoolExecutor(1, thread_name_prefix=STREAM_THREAD)
        try:
            for i, (values, syndromes) in enumerate(chunks):
                n = values.shape[1] if values.ndim == 2 else 0
                if values.shape != (self.code.n_vars, n) or n < 1:
                    raise ValueError(
                        f"chunk values must be [{self.code.n_vars}, n], "
                        f"n >= 1, got {values.shape}")
                if syndromes.shape != (self.code.n_checks, n):
                    raise ValueError(
                        f"chunk syndromes must be [{self.code.n_checks}, "
                        f"{n}], got {syndromes.shape}")
                t0 = time.perf_counter()
                slot = ring[i % depth]
                pool_values, pool_syn, uploaded = self._stage(
                    values, syndromes, slot)
                if streams is not None:  # consumed on the compute stream
                    pool_values.record_stream(streams[1])
                    pool_syn.record_stream(streams[1])
                inflight.append((worker.submit(
                    self._decode_chunk, dyn_params, n, pool_values,
                    pool_syn, input_is_llr, slot, uploaded, streams), t0))
                del pool_values, pool_syn
                if len(inflight) >= depth:
                    yield self._finish_chunk(*inflight.popleft())
            while inflight:
                yield self._finish_chunk(*inflight.popleft())
        finally:
            worker.shutdown(wait=True, cancel_futures=True)
            if streams is not None:
                for stream in streams:
                    stream.synchronize()

    def _decode_chunk(self, dyn_params, n, pool_values, pool_syn,
                      input_is_llr, slot, uploaded, streams):
        """decode_streamed's worker: decode one chunk on the compute stream
        once its upload is done, then queue its results' copy into the
        slot's pinned buffer on the readback stream. Returns (results,
        stats, events); on the card the results are ready when
        ``events["readback_end"]`` is."""
        if streams is None:
            res, stats = self.decode_presorted(
                dyn_params, n, pool_values, pool_syn, fetch_results=False,
                input_is_llr=input_is_llr)
            return res.numpy().view(np.uint32), stats, None
        _, compute, readback = streams
        events = {"upload_start": uploaded[0], "upload_end": uploaded[1]}
        for name in ("decode_start", "decode_end", "readback_end"):
            events[name] = torch.cuda.Event(enable_timing=True)
        with torch.cuda.device(self.device), torch.cuda.stream(compute):
            compute.wait_event(uploaded[1])
            events["decode_start"].record(compute)
            res, stats = self.decode_presorted(
                dyn_params, n, pool_values, pool_syn, fetch_results=False,
                input_is_llr=input_is_llr)
            events["decode_end"].record(compute)
        out = slot.buffer("results", (n, self.n_words), torch.int32)
        with torch.cuda.device(self.device), torch.cuda.stream(readback):
            readback.wait_event(events["decode_end"])
            res.record_stream(readback)
            out.copy_(res, non_blocking=True)
            events["readback_end"].record(readback)
        return out, stats, events

    def _finish_chunk(self, future, t0: float):
        """The next chunk in order: its worker's result (or exception), its
        readback waited for, the results copied out of the pinned slot
        that a later chunk reuses."""
        with tracing.span("ldpc.chunk_wait"):
            results, stats, events = future.result()
        if events is not None:
            with tracing.span("ldpc.readback_wait"):
                events["readback_end"].synchronize()
                results = results.numpy().copy().view(np.uint32)
        return results, dataclasses.replace(
            stats, elapsed_seconds=time.perf_counter() - t0,
            decode_seconds=stats.elapsed_seconds, events=events)

    def upload_pools(self, values: np.ndarray, syndromes: np.ndarray):
        """Natural-order host arrays -> the device pools in the decoder's
        sorted layouts, as :meth:`decode_presorted` and
        :meth:`profile_phases` take them, ready for the current stream."""
        pool_values, pool_syn, events = self._stage(values, syndromes,
                                                    _Slot())
        if events is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(events[1])
            pool_values.record_stream(stream)
            pool_syn.record_stream(stream)
        return pool_values, pool_syn

    def _cuda_streams(self):
        """(copy, compute, readback) streams of this decoder, made together
        so that PyTorch's stream pool gives three distinct ones."""
        if self._streams is None:
            self._streams = tuple(torch.cuda.Stream(self.device)
                                  for _ in range(3))
        return self._streams

    def _stage(self, values: np.ndarray, syndromes: np.ndarray,
               slot: _Slot):
        """The one route of host frames to the device: (pool_values,
        pool_syn, events) in the sorted layouts. On the card the natural
        arrays are cast into ``slot``'s pinned buffers (:func:`_copy_into`,
        as ``astype`` casts, without the GIL), copied asynchronously on the
        copy stream and permuted there by a row gather; ``events`` is
        (start, end) on the copy stream, and the pools belong to it until
        a consumer waits on ``end`` and records its stream on them. On the
        CPU the same gather runs at once and ``events`` is None."""
        with tracing.span("ldpc.stage"):
            vn_order, cn_order = self._io_orders
            cuda = self.device.type == "cuda"
            with tracing.span("ldpc.stage.slot_wait"):
                if slot.uploaded is not None:  # its last upload has left it
                    slot.uploaded.synchronize()
            with tracing.span("ldpc.stage.cast"):
                if cuda:
                    host_v = slot.buffer("values", values.shape, torch.float32)
                    host_s = slot.buffer("syndromes", syndromes.shape,
                                         torch.int8)
                    _copy_into(host_v.numpy(), values)
                    _copy_into(host_s.numpy(), syndromes)
                else:
                    host_v = torch.from_numpy(np.ascontiguousarray(
                        values, dtype=np.float32))
                    host_s = torch.from_numpy(np.ascontiguousarray(
                        syndromes, dtype=np.int8))
            with tracing.span("ldpc.stage.upload"):
                if not cuda:
                    return (host_v.index_select(0, vn_order),
                            host_s.index_select(0, cn_order), None)
                copy = self._cuda_streams()[0]
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                with torch.cuda.stream(copy):
                    start.record(copy)
                    pool_values = host_v.to(self.device, non_blocking=True
                                            ).index_select(0, vn_order)
                    pool_syn = host_s.to(self.device, non_blocking=True
                                         ).index_select(0, cn_order)
                    end.record(copy)
                slot.uploaded = end
                return pool_values, pool_syn, (start, end)

    def _start(self, pool_values, pool_syn, n_pool: int, pre: float,
               input_is_llr: bool = False) -> _Lanes:
        """Load the first B frames of the pool into the lanes and
        initialise their messages."""
        t, dev, B = self.tables, self.device, self._parallel_factor
        if pool_values.shape != (t.n_vars, n_pool) or pool_syn.shape != (
                t.n_checks, n_pool):
            raise ValueError("pool shapes do not match the code and n_vecs")
        frame_ids = np.arange(B)
        if n_pool == B:  # single fill: the lane -> pool map is the identity
            vals = pool_values
            syn = pool_syn.clone()
        else:
            safe = torch.from_numpy(np.minimum(frame_ids, n_pool - 1)).to(dev)
            vals = pool_values[:, safe]
            syn = pool_syn[:, safe]
        llr = self._lane_llr(vals, input_is_llr)
        return _Lanes(
            msgs=self._init_messages(llr, t, self.msg_dtype, pre),
            llr=llr, syn=syn.view(*self._node_shape[1], B),
            frame_ids=frame_ids, active=frame_ids < n_pool,
            iters_done=np.zeros(B, np.int64),
            iters_out=np.zeros(n_pool, np.int32),
            pool_next=min(B, n_pool),
            results=torch.zeros((n_pool, self.n_words), dtype=torch.int32,
                                device=dev),
            input_is_llr=input_is_llr,
            retire_table=(retire.RetireStaging(B, dev)
                          if dev.type == "cuda" else None))

    def _superstep(self, st: _Lanes, pool_values, pool_syn, k: int,
                   max_iter: int, pre: float) -> None:
        """k iterations, the parity flags' one host read, then retire the
        finished lanes (packing their bits into the results) and refill
        them from the pool; updates ``st`` in place."""
        self._launch(st, k, pre)
        self._finish(st, pool_values, pool_syn, max_iter, pre)

    def _launch(self, st: _Lanes, k: int, pre: float) -> None:
        """A superstep's first half: k iterations on the current stream, the
        last one emitting hard decisions (kept in ``st.bits``), then the [B]
        violated flags' copy to the host started: on the card into a pinned
        buffer, asynchronously, behind the event ``st.flags_ready``, so
        that the host can launch another replica's iterations before it
        reads them (:meth:`_finish`). While tracing, timing events after
        the flags' copy and at the next launch bound the superstep's turn."""
        if st.turn_start is not None:
            turn_end = torch.cuda.Event(enable_timing=True)
            turn_end.record()
            st.turns.append((st.turn_start, turn_end))
            st.turn_start = None
        if not st.active.all():  # the pool has run dry
            st.drain_supersteps += 1
        with tracing.span("ldpc.iterate"):
            extra = {"fresh": st.fresh} if self._lane_reset else {}
            st.msgs, st.bits, violated = self._run_iterations(
                st.msgs, st.llr, st.syn, self.tables, k, pre, **extra)
            st.iters_done += k
            if self.device.type != "cuda":
                st.flags = violated
                return
            if st.flags is None:
                st.flags = torch.empty(violated.shape, dtype=violated.dtype,
                                       pin_memory=True)
                st.flags_ready = torch.cuda.Event()
            st.flags.copy_(violated, non_blocking=True)
            st.flags_ready.record()
            if tracing.active():
                st.turn_start = torch.cuda.Event(enable_timing=True)
                st.turn_start.record()
                if st.turns is None:
                    st.turns = []

    def _finish(self, st: _Lanes, pool_values, pool_syn, max_iter: int,
                pre: float) -> None:
        """A superstep's second half, on the stream of its :meth:`_launch`:
        the flags' host read (the superstep's one wait), then retire the
        finished lanes (packing their bits into the results) and refill
        them from the pool; updates ``st`` in place."""
        t, dev = self.tables, self.device
        n_pool = st.iters_out.size
        with tracing.span("ldpc.flag_wait"):
            if st.flags_ready is not None:
                st.flags_ready.synchronize()
            viol = st.flags.numpy()
        with tracing.span("ldpc.retire"):
            done = st.active & (~viol | (st.iters_done >= max_iter))
            bits, st.bits = st.bits, None
            if done.any():  # pack the finished lanes' bits
                lanes = np.nonzero(done)[0]
                ids = st.frame_ids[lanes]
                if st.retire_table is not None:  # one kernel, in place
                    retire.pack_retired(bits, self._src_row, lanes, ids,
                                        st.results, st.retire_table)
                else:
                    st.results[torch.from_numpy(ids)] = self._pack(
                        bits[..., torch.from_numpy(lanes)])
                st.iters_out[ids] = st.iters_done[lanes]

        with tracing.span("ldpc.refill"):  # flood_refill analog
            order = np.cumsum(done) - done
            new_ids = st.pool_next + order
            has_new = done & (new_ids < n_pool)
            st.frame_ids = np.where(has_new, new_ids, st.frame_ids)
            st.active = np.where(done, has_new, st.active)
            st.pool_next = min(st.pool_next + int(done.sum()), n_pool)
            st.iters_done[done] = 0
            st.refills += int(has_new.sum())
            st.fresh = None
            if has_new.any():
                lanes = torch.from_numpy(np.nonzero(has_new)[0]).to(dev)
                ids = torch.from_numpy(st.frame_ids[has_new]).to(dev)
                st.llr[..., lanes] = self._lane_llr(pool_values[:, ids],
                                                    st.input_is_llr)
                st.syn[..., lanes] = pool_syn[:, ids].view(
                    *self._node_shape[1], -1)
                if self._lane_reset:
                    st.fresh = torch.from_numpy(has_new).to(dev)
                else:  # the refilled lanes' messages start afresh now
                    msgs = _as_bits(st.msgs[0])
                    msgs[:, lanes] = _as_bits(self._init_lanes(
                        st.llr[:, lanes], t, self.msg_dtype, pre))

    def decode_presorted(
        self,
        dyn_params: DynamicParams,
        n_vecs: int,
        pool_values: torch.Tensor,  # [n_vars, n_vecs] f32, SORTED vn order
        pool_syn: torch.Tensor,     # [n_checks, n_vecs] int8, SORTED cn order
        host_poll: bool = False,
        progress=None,
        fetch_results: bool = True,
        input_is_llr: bool = False,
    ):
        """Device-pool entry point: pools already on ``self.device`` in the
        decoder's sorted layouts; the arguments are the JAX decoder's, in
        its order. Returns what :meth:`decode` returns, or with
        ``fetch_results=False`` the results left on the device: an int32
        tensor [n_vecs, n_words] holding the uint32 words' bit patterns.

        This decoder always reads one [B] flag vector per superstep, in
        both modes. The clock follows the JAX decoder's two modes: with
        ``host_poll`` it starts after the lanes' first load and message
        init (its host-polled loop), otherwise before them (its fused
        loop, which includes the init); it stops when the results are
        ready. ``progress``: called with the number of frames not yet
        retired after every superstep. ``input_is_llr``: the pool holds
        LLRs, not channel values (:meth:`decoding_input_is_llr`)."""
        with tracing.span("ldpc.decode"):
            (st,), supersteps, t0 = self._lockstep(
                [self], [(pool_values, pool_syn)], n_vecs, dyn_params,
                input_is_llr=input_is_llr, host_poll=host_poll,
                progress=progress)
            with tracing.span("ldpc.sync"):
                _sync(self.device)
            elapsed = time.perf_counter() - t0
            k = dyn_params.num_iter_check_parity
            burst = max(0, dyn_params.num_iter_first_check - k)

            stats = DecodeStats(
                iterations=st.iters_out,
                total_supersteps=supersteps,
                total_iterations=supersteps * k + burst,
                elapsed_seconds=elapsed,
                batch_size=self._parallel_factor,
                refills=st.refills,
                drain_supersteps=st.drain_supersteps,
                turn_ms=st.turn_ms(),
            )
            if not fetch_results:
                return st.results, stats
            return st.results.cpu().numpy().view(np.uint32), stats

    # ---- several devices ---------------------------------------------------
    def decode_sharded(
        self,
        dyn_params: DynamicParams,
        n_vecs: int,
        values: np.ndarray,      # [n_vars, n_vecs] float32, natural order
        syndromes: np.ndarray,   # [n_checks, n_vecs] 0/1, natural order
        mesh,
    ) -> tuple[np.ndarray, DecodeStats]:
        """Decode with the frame pool dealt over ``mesh``'s positions (a
        :class:`..parallel.mesh.BatchMesh` of this process), the JAX
        decoder's ``decode_sharded`` in its arguments and return.

        Frames are dealt round-robin (:func:`..parallel.mesh.deal`), padded
        to a multiple of the mesh size with -1.0 frames, which decode at
        their first check; each position refills its lanes only from its
        own pool, so B lanes run on every position (``batch_size`` = B x
        positions). One replica of this decoder runs each position, on its
        device and its own streams (:meth:`_replica`, cached), and one host
        loop drives them in lockstep while their remaining frames sum to
        more than 0 (the JAX loop's psum). The libraries are loaded and the
        pools uploaded before the clock, which then runs from the lanes'
        first load to the results on the host. ``total_supersteps`` is the
        loop's count, the JAX devices' maximum."""
        if values.shape != (self.code.n_vars, n_vecs):
            raise ValueError(f"values must be [{self.code.n_vars}, {n_vecs}]")
        if syndromes.shape != (self.code.n_checks, n_vecs):
            raise ValueError(
                f"syndromes must be [{self.code.n_checks}, {n_vecs}]")
        if len(mesh.local_positions()) != mesh.size:
            raise ValueError("the mesh spans processes: use "
                             "parallel.multiprocess.decode_multiprocess")
        order = deal(n_vecs, mesh.size)
        pools = []
        for g, idx in enumerate(order):
            # position g's frames g, g + n_dev, ... (a strided view), then
            # its pads
            n_real = int((idx < n_vecs).sum())
            v = np.empty((self.code.n_vars, idx.size), np.float32)
            s = np.empty((self.code.n_checks, idx.size), np.int8)
            _copy_into(v[:, :n_real], values[:, g::mesh.size])
            _copy_into(s[:, :n_real], syndromes[:, g::mesh.size])
            v[:, n_real:], s[:, n_real:] = pad_frames(
                self.code.n_vars, self.code.n_erased_vars, self.code.n_checks,
                idx.size - n_real)
            pools.append((v, s))
        res, states, supersteps, elapsed = self._decode_dealt(
            mesh.devices, pools, dyn_params)
        k = dyn_params.num_iter_check_parity
        burst = max(0, dyn_params.num_iter_first_check - k)
        timed = [st.turn_ms() for st in states if st.turns is not None]
        return reassemble(res, order, n_vecs), DecodeStats(
            iterations=reassemble([st.iters_out for st in states], order,
                                  n_vecs),
            total_supersteps=supersteps,
            total_iterations=supersteps * k + burst,
            elapsed_seconds=elapsed,
            batch_size=self._parallel_factor * mesh.size,
            refills=sum(st.refills for st in states),
            drain_supersteps=sum(st.drain_supersteps for st in states),
            turn_ms=[ms for t in timed for ms in t] if timed else None)

    def _decode_dealt(self, devices, pools, dyn_params: DynamicParams,
                      reduce=None, before_clock=None):
        """Decode one host pool (values [n_vars, n], syndromes [n_checks,
        n] in natural order, the same n for all) per device of ``devices``,
        each on its replica, in lockstep (:meth:`_lockstep`, given
        ``reduce`` and ``before_clock``) once every pool is on its device;
        the clock stops with the results on the host. Returns (results [n,
        n_words] uint32 per device, the lane states per device (their
        ``iters_out``: iterations [n]), supersteps, seconds on the
        clock)."""
        seen: dict[torch.device, int] = {}
        reps = []
        for d in devices:
            d = canonical_device(d)
            seen[d] = seen.get(d, 0) + 1
            reps.append(self._replica(d, seen[d] - 1))
        staged = []
        for rep, (values, syndromes) in zip(reps, pools):
            with rep._scope():
                rep._load_libraries()
                staged.append(rep.upload_pools(values, syndromes))
        n = staged[0][0].shape[1] if staged else 0
        with tracing.span("ldpc.decode"):
            states, supersteps, t0 = self._lockstep(
                reps, staged, n, dyn_params, reduce=reduce,
                before_clock=before_clock)
            results = []
            with tracing.span("ldpc.sync"):
                for rep, st in zip(reps, states):
                    with rep._scope():
                        results.append(
                            st.results.cpu().numpy().view(np.uint32))
        elapsed = time.perf_counter() - t0
        return results, states, supersteps, elapsed

    def _lockstep(self, reps, pools, n: int, dyn_params: DynamicParams,
                  input_is_llr: bool = False, host_poll: bool = False,
                  progress=None, reduce=None, before_clock=None):
        """The decode loop, for this decoder alone and for its replicas:
        ``reps[i]`` decodes ``pools[i]`` ((values, syndromes) of n frames on
        its device, in the sorted layouts), this decoder on the current
        stream and a replica in its own scope (:meth:`_scope`). After a
        wait for every device and ``before_clock`` (or None; a barrier
        across processes) the clock starts; with ``host_poll`` it restarts
        after the lanes' first load and message init. Every superstep
        launches the iterations of every decoder with frames left (a
        drained one skips, which changes no result) before it reads any
        decoder's flags; ``reduce`` (the sum across processes, or None)
        turns their remaining frames into the loop's count, which
        ``progress`` (or None) gets, and the loop ends when it is 0.
        Returns (the lane states, supersteps, the clock's start)."""
        k = dyn_params.num_iter_check_parity
        if k < 1:
            raise ValueError(f"num_iter_check_parity must be >= 1, got {k}")
        pre = pre_from_infinity_threshold(dyn_params.infinity_threshold)
        burst = max(0, dyn_params.num_iter_first_check - k)
        scopes = [contextlib.nullcontext if rep is self else rep._scope
                  for rep in reps]

        def sync_all():
            for rep, scope in zip(reps, scopes):
                with scope():
                    _sync(rep.device)

        sync_all()
        if before_clock is not None:
            before_clock()
        t0 = time.perf_counter()
        states = []
        with tracing.span("ldpc.start"):
            for rep, scope, (pv, ps) in zip(reps, scopes, pools):
                with scope():
                    states.append(rep._start(pv, ps, n, pre, input_is_llr))
        if host_poll:
            sync_all()
            t0 = time.perf_counter()
        if burst:
            with tracing.span("ldpc.iterate"):
                for rep, scope, st in zip(reps, scopes, states):
                    with scope():
                        rep._run_burst(st.msgs, st.llr, st.syn, rep.tables,
                                       burst, pre)
                    st.iters_done += burst
        supersteps = 0
        while True:
            live = [i for i, st in enumerate(states) if st.n_remaining]
            for i in live:
                with scopes[i]():
                    reps[i]._launch(states[i], k, pre)
            for i in live:
                with scopes[i]():
                    reps[i]._finish(states[i], *pools[i],
                                    dyn_params.num_iter_max, pre)
            supersteps += 1
            remaining = sum(st.n_remaining for st in states)
            if reduce is not None:
                remaining = reduce(remaining)
            if progress is not None:
                progress(remaining)
            if remaining == 0:
                break
        return states, supersteps, t0

    def _replica(self, device: torch.device, index: int) -> "LDPCDecoder":
        """The decoder of the ``index``-th mesh position on ``device``: a
        shallow copy of this one with its own streams, sharing the tables
        (and the I/O and retire rows) of this decoder on its own device,
        else a copy moved to ``device`` once and shared by that device's
        replicas. Cached by (device, index)."""
        key = (device, index)
        rep = self._replicas.get(key)
        if rep is not None:
            return rep
        rep = copy.copy(self)
        rep._replicas, rep._streams = {}, None
        if device != canonical_device(self.device):
            twin = next((r for (d, _), r in self._replicas.items()
                         if d == device), None)
            for name in ("tables", "_io_orders", "_src_row"):
                value = getattr(twin, name) if twin is not None else \
                    _on_device(getattr(self, name), device)
                setattr(rep, name, value)
            rep.device = device
        self._replicas[key] = rep
        return rep

    def _scope(self):
        """This decoder's device and compute stream made current (nothing
        on the CPU)."""
        if self.device.type != "cuda":
            return contextlib.nullcontext()
        scope = contextlib.ExitStack()
        scope.enter_context(torch.cuda.device(self.device))
        scope.enter_context(torch.cuda.stream(self._cuda_streams()[1]))
        return scope

    def _load_libraries(self) -> None:
        """Load (building at first use) the kernel libraries this decoder
        launches, so that no build falls inside a clock."""
        if self.device.type != "cuda":
            return
        from ldpc_decoder_tpu_torch.ops import _kernels

        if isinstance(self.tables, GeneralTables):
            names = ["retire", "general"]
        else:
            names = ["retire", "qc_regular"
                     if isinstance(self.tables, QCRegularTables)
                     else "qc_grouped"]
            if self.params.algorithm == "min-sum":
                names.append("qc_minsum")
        for name in names:
            _kernels.load(name)

    def profile_phases(self, pool_values, pool_syn,
                       dyn_params: DynamicParams, n_vecs: int,
                       repeats: int = 3) -> dict[str, float]:
        """Per-phase step timing in seconds (the reference's print_time
        instrumentation of its refill steps, ldpc_decoder_gpu.cu:275-281,
        517-601; ``decoder.py:836-910`` of the JAX package), on device
        pools as :meth:`upload_pools` makes them: one BP iteration, the
        parity and hard-decision overhead of a superstep's last iteration,
        the whole superstep with its retire and refill, and the message
        init that a refill runs. Each is the mean of ``repeats`` calls
        after one warm-up call, between device synchronisations. A
        superstep that runs out of device memory reads NaN."""
        k = dyn_params.num_iter_check_parity
        pre = pre_from_infinity_threshold(dyn_params.infinity_threshold)
        t = self.tables
        st = self._start(pool_values, pool_syn, n_vecs, pre)

        def timeit(fn):
            fn()  # warm
            _sync(self.device)
            t0 = time.perf_counter()
            for _ in range(repeats):
                fn()
            _sync(self.device)
            return (time.perf_counter() - t0) / repeats

        def run_k(kk):
            return timeit(lambda: self._run_iterations(
                st.msgs, st.llr, st.syn, t, kk, pre))

        t1 = run_k(1)
        tk = run_k(k) if k > 1 else t1
        # clamped like the differences below: on a loaded host the k-iteration
        # run can read faster than the one-iteration run
        per_iter = max((tk - t1) / (k - 1), 0.0) if k > 1 else t1
        t_init = timeit(lambda: self._init_messages(st.llr, t,
                                                    self.msg_dtype, pre))
        try:
            t_super = timeit(lambda: self._superstep(
                st, pool_values, pool_syn, k, dyn_params.num_iter_max, pre))
        except torch.cuda.OutOfMemoryError:
            t_super = float("nan")
        return {
            "bp_iteration": per_iter,
            "parity_and_bits": max(t1 - per_iter, 0.0),
            "superstep_total": t_super,
            "retire_refill_pack": max(t_super - tk, 0.0),
            "refill_message_init": t_init,
        }
