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
  (:mod:`..ops.general`); float8_e5m2 messages are refused there (the JAX
  package sends them to its XLA path, which is not ported).

Every family runs sum-product and min-sum and exposes the same init, burst
and superstep functions. A pool of all frames of a run lives on the device
in the decoder's sorted layouts; B = parallel_factor lanes decode in
parallel; every k iterations a superstep checks parity, retires finished
or over-budget lanes (packing their hard decisions into the results) and
refills them from the pool.

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
"""

from __future__ import annotations

import dataclasses
import logging
import math
import time
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


def _pack_bits_natural(bits: torch.Tensor, block_perm: torch.Tensor,
                       n_words: int) -> torch.Tensor:
    """bits [C, Z, n] int8 in sorted column blocks -> [n, n_words] int32
    holding the uint32 words of each frame's bits in natural order (bit j
    of word w = variable 32w + j; the deinterlace_output analog,
    flood.cu:277-295), when the natural-order gather is a permute of whole
    Z-blocks (``block_perm``: natural block -> sorted block)."""
    C, Z, n = bits.shape
    return _pack_words(bits[block_perm].reshape(C * Z, n), n_words)


def _block_perm(vn_pos: np.ndarray, Z: int) -> np.ndarray | None:
    """Natural column block -> sorted block when ``vn_pos`` (natural ->
    sorted variable) maps whole Z-blocks in order, else None (an
    interleaved numbering; ``decoder.py:476-483`` of the JAX package)."""
    cand = vn_pos[::Z] // Z
    rows = cand[:, None] * Z + np.arange(Z)[None, :]
    return cand if np.array_equal(vn_pos.reshape(-1, Z), rows) else None


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
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


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

    @property
    def n_remaining(self) -> int:
        """Frames not yet retired: active lanes plus the pool's rest."""
        return int(self.active.sum()) + (self.iters_out.size
                                         - self.pool_next)


def _inverse(perm: np.ndarray) -> np.ndarray:
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size, dtype=perm.dtype)
    return inv


def _pack_words(nat: torch.Tensor, n_words: int) -> torch.Tensor:
    """bits [n_vars, n] int8 in natural order -> [n, n_words] int32 words
    (see :func:`_pack_bits_natural`)."""
    n_vars, n = nat.shape
    pad = n_words * 32 - n_vars
    if pad:
        nat = torch.cat([nat, nat.new_zeros((pad, n))])
    x = nat.view(n_words, 32, n).to(torch.int64)
    words = torch.zeros((n_words, n), dtype=torch.int64, device=nat.device)
    for j in range(32):
        words |= x[:, j] << j
    # [0, 2^32) -> the int32 with the same bit pattern
    words -= (words >> 31) << 32
    return words.to(torch.int32).T.contiguous()


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
    min-sum run on every family; int8 messages take the grouped QC family
    or the general path; float8_e5m2 messages need QC structure.
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
        if qc is None and self.msg_dtype == torch.float8_e5m2:
            raise NotImplementedError(
                "message_dtype='float8_e5m2' needs a QC code: the general "
                "(any-alist) path has no float8_e5m2 kernels yet (ROADMAP "
                "Queue 1 item 15); use bfloat16 or int8 here")
        if qc is None:
            self._init_general(cc or compile_code(self.code))
        else:
            self._init_qc(qc, perm_v, perm_c)
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
        vn_pos = qct.vn_pos.cpu().numpy()
        perm = _block_perm(vn_pos, Z)
        self._block_perm = None
        if perm is not None:
            self._block_perm = torch.from_numpy(perm).to(self.device)
            self._pack = lambda bits: _pack_bits_natural(
                bits, self._block_perm, self.n_words)
        else:  # gather rows: user variable u sits at sorted row vn_pos[u]
            rows = qct.vn_pos.to(self.device)
            self._pack = lambda bits: _pack_words(
                bits.reshape(-1, bits.shape[-1]).index_select(0, rows),
                self.n_words)
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
        self._pack = lambda bits: _pack_words(
            bits.index_select(0, t.vn_pos), self.n_words)
        self._vn_order_io = t.vn_order.cpu().numpy()
        self._cn_order_io = t.cn_order.cpu().numpy()

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

    def upload_pools(self, values: np.ndarray, syndromes: np.ndarray):
        """Natural-order host arrays -> the device pools in the decoder's
        sorted layouts, as :meth:`decode_presorted` and
        :meth:`profile_phases` take them."""
        pool_values = torch.from_numpy(np.ascontiguousarray(
            values[self._vn_order_io], dtype=np.float32)).to(self.device)
        pool_syn = torch.from_numpy(np.ascontiguousarray(
            syndromes[self._cn_order_io], dtype=np.int8)).to(self.device)
        return pool_values, pool_syn

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
            input_is_llr=input_is_llr)

    def _superstep(self, st: _Lanes, pool_values, pool_syn, k: int,
                   max_iter: int, pre: float) -> None:
        """k iterations, the parity flags' one host read, then retire the
        finished lanes (packing their bits into the results) and refill
        them from the pool; updates ``st`` in place."""
        t, dev = self.tables, self.device
        n_pool = st.iters_out.size
        extra = {"fresh": st.fresh} if self._lane_reset else {}
        st.msgs, bits, violated = self._run_iterations(
            st.msgs, st.llr, st.syn, t, k, pre, **extra)
        st.iters_done += k
        viol = violated.cpu().numpy()  # the superstep's one host read
        done = st.active & (~viol | (st.iters_done >= max_iter))

        if done.any():  # retire: pack the finished lanes' bits
            lanes = np.nonzero(done)[0]
            ids = st.frame_ids[lanes]
            packed = self._pack(bits[..., torch.from_numpy(lanes).to(dev)])
            st.results[torch.from_numpy(ids).to(dev)] = packed
            st.iters_out[ids] = st.iters_done[lanes]

        # refill from the pool (flood_refill analog)
        order = np.cumsum(done) - done
        new_ids = st.pool_next + order
        has_new = done & (new_ids < n_pool)
        st.frame_ids = np.where(has_new, new_ids, st.frame_ids)
        st.active = np.where(done, has_new, st.active)
        st.pool_next = min(st.pool_next + int(done.sum()), n_pool)
        st.iters_done[done] = 0
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
                st.msgs[0][:, lanes] = self._init_lanes(
                    st.llr[:, lanes], t, self.msg_dtype, pre)

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
        k = dyn_params.num_iter_check_parity
        if k < 1:
            raise ValueError(f"num_iter_check_parity must be >= 1, got {k}")
        pre = pre_from_infinity_threshold(dyn_params.infinity_threshold)
        burst = max(0, dyn_params.num_iter_first_check - k)

        _sync(self.device)
        t0 = time.perf_counter()
        st = self._start(pool_values, pool_syn, n_vecs, pre, input_is_llr)
        if host_poll:
            _sync(self.device)
            t0 = time.perf_counter()
        if burst:
            self._run_burst(st.msgs, st.llr, st.syn, self.tables, burst, pre)
            st.iters_done += burst
        supersteps = 0
        while True:
            self._superstep(st, pool_values, pool_syn, k,
                            dyn_params.num_iter_max, pre)
            supersteps += 1
            n_remaining = st.n_remaining
            if progress is not None:
                progress(n_remaining)
            if n_remaining == 0:
                break
        _sync(self.device)
        elapsed = time.perf_counter() - t0

        stats = DecodeStats(
            iterations=st.iters_out,
            total_supersteps=supersteps,
            total_iterations=supersteps * k + burst,
            elapsed_seconds=elapsed,
            batch_size=self._parallel_factor,
        )
        if not fetch_results:
            return st.results, stats
        return st.results.cpu().numpy().view(np.uint32), stats

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
        per_iter = (tk - t1) / (k - 1) if k > 1 else t1
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
