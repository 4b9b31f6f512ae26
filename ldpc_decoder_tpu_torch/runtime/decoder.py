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
  takes the regular family (:mod:`..ops.qc_regular`), any other base, and
  every int8 decode, the grouped one (:mod:`..ops.qc_grouped`);
- a code without QC structure takes the general path
  (:mod:`..ops.general`).

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
                 "int8": torch.int8}
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
    or the general path. ``detect_seconds`` is the detection's time.
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
        # base is their one-group special case), as in the JAX decoder
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

    # ------------------------------------------------------------------
    def _lane_llr(self, vals: torch.Tensor):
        """Pool values [n_vars, n] -> LLR state [*node shape, n] in the
        kernels' consumption dtype (the message dtype; bfloat16 for int8
        messages), erased rows zeroed."""
        llr = self.channel.llr_from_channel(vals).masked_fill(
            self.tables.erased_mask_sorted, 0.0)
        return llr.to(self._llr_dtype).view(*self._node_shape[0], -1)

    def decode(
        self,
        dyn_params: DynamicParams,
        n_vecs: int,
        values: np.ndarray,      # [n_vars, n_vecs] float32, natural order
        syndromes: np.ndarray,   # [n_checks, n_vecs] 0/1, natural order
    ) -> tuple[np.ndarray, DecodeStats]:
        """Decode ``n_vecs`` frames; returns (packed bits [n_vecs, n_words]
        uint32 in natural per-frame layout, stats). ``values[i, v]`` is the
        i-th channel value of frame v (h/ldpc_decoder_gpu.h:94 transposed).
        The pools are uploaded in sorted layouts before the timed region."""
        if values.shape != (self.code.n_vars, n_vecs):
            raise ValueError(f"values must be [{self.code.n_vars}, {n_vecs}]")
        if syndromes.shape != (self.code.n_checks, n_vecs):
            raise ValueError(
                f"syndromes must be [{self.code.n_checks}, {n_vecs}]")
        pool_values = torch.from_numpy(np.ascontiguousarray(
            values[self._vn_order_io], dtype=np.float32)).to(self.device)
        pool_syn = torch.from_numpy(np.ascontiguousarray(
            syndromes[self._cn_order_io], dtype=np.int8)).to(self.device)
        return self.decode_presorted(dyn_params, n_vecs, pool_values,
                                     pool_syn)

    def decode_presorted(
        self,
        dyn_params: DynamicParams,
        n_vecs: int,
        pool_values: torch.Tensor,  # [n_vars, n_vecs] f32, SORTED vn order
        pool_syn: torch.Tensor,     # [n_checks, n_vecs] int8, SORTED cn order
    ) -> tuple[np.ndarray, DecodeStats]:
        """Device-pool entry point: pools already on ``self.device`` in the
        decoder's sorted layouts. Returns what :meth:`decode` returns; times
        from the pools being on the device to the results being ready."""
        k = dyn_params.num_iter_check_parity
        if k < 1:
            raise ValueError(f"num_iter_check_parity must be >= 1, got {k}")
        max_iter = dyn_params.num_iter_max
        pre = pre_from_infinity_threshold(dyn_params.infinity_threshold)
        burst = max(0, dyn_params.num_iter_first_check - k)
        t, dev, B = self.tables, self.device, self._parallel_factor
        n_pool = n_vecs
        if pool_values.shape != (t.n_vars, n_pool) or pool_syn.shape != (
                t.n_checks, n_pool):
            raise ValueError("pool shapes do not match the code and n_vecs")

        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        frame_ids = np.arange(B)
        active = frame_ids < n_pool
        iters_done = np.zeros(B, np.int64)
        iters_out = np.zeros(n_pool, np.int32)
        pool_next = min(B, n_pool)
        results = torch.zeros((n_pool, self.n_words), dtype=torch.int32,
                              device=dev)
        if n_pool == B:  # single fill: the lane -> pool map is the identity
            vals = pool_values
            syn = pool_syn.clone()
        else:
            safe = torch.from_numpy(np.minimum(frame_ids, n_pool - 1)).to(dev)
            vals = pool_values[:, safe]
            syn = pool_syn[:, safe]
        llr = self._lane_llr(vals)
        syn = syn.view(*self._node_shape[1], B)
        msgs = self._init_messages(llr, t, self.msg_dtype, pre)
        if burst:
            self._run_burst(msgs, llr, syn, t, burst, pre)
            iters_done += burst

        fresh = None
        supersteps = 0
        while True:
            extra = {"fresh": fresh} if self._lane_reset else {}
            msgs, bits, violated = self._run_iterations(
                msgs, llr, syn, t, k, pre, **extra)
            supersteps += 1
            iters_done += k
            viol = violated.cpu().numpy()  # the superstep's one host read
            done = active & (~viol | (iters_done >= max_iter))

            if done.any():  # retire: pack the finished lanes' bits
                lanes = np.nonzero(done)[0]
                ids = frame_ids[lanes]
                packed = self._pack(bits[..., torch.from_numpy(lanes).to(dev)])
                results[torch.from_numpy(ids).to(dev)] = packed
                iters_out[ids] = iters_done[lanes]

            # refill from the pool (flood_refill analog)
            order = np.cumsum(done) - done
            new_ids = pool_next + order
            has_new = done & (new_ids < n_pool)
            frame_ids = np.where(has_new, new_ids, frame_ids)
            active = np.where(done, has_new, active)
            pool_next = min(pool_next + int(done.sum()), n_pool)
            iters_done[done] = 0
            fresh = None
            if has_new.any():
                lanes = torch.from_numpy(np.nonzero(has_new)[0]).to(dev)
                ids = torch.from_numpy(frame_ids[has_new]).to(dev)
                llr[..., lanes] = self._lane_llr(pool_values[:, ids])
                syn[..., lanes] = pool_syn[:, ids].view(
                    *self._node_shape[1], -1)
                if self._lane_reset:
                    fresh = torch.from_numpy(has_new).to(dev)
                else:  # the refilled lanes' messages start afresh now
                    msgs[0][:, lanes] = self._init_lanes(
                        llr[:, lanes], t, self.msg_dtype, pre)

            if not active.any() and pool_next == n_pool:
                break
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        elapsed = time.perf_counter() - t0

        stats = DecodeStats(
            iterations=iters_out,
            total_supersteps=supersteps,
            total_iterations=supersteps * k + burst,
            elapsed_seconds=elapsed,
            batch_size=B,
        )
        return results.cpu().numpy().view(np.uint32), stats
