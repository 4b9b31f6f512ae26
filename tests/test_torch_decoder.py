"""The port's ``LDPCDecoder.decode`` against the JAX package's, end to end
on the small p41-shaped code (the grouped family) and on a small regular
(3,6) code (the regular family, over BI-AWGN and the erasure channel).

Sum-product: the JAX side runs ``kernel_impl="xla"``, the oracle the Pallas
kernels are held bit-identical to. In float32 the decoded words and the
per-frame iteration counts must be equal (φ differs by ulps between the
two, far below what moves a hard decision at this noise level); in
bfloat16 both decode every frame and their mean iterations agree within
one check period k. Min-sum: the JAX side runs its default kernels (the
Pallas kernels in interpret mode, routed as on the TPU), and words and
per-frame iterations must be equal in every dtype: no transcendental is
involved, and the α tables run with β = 0 (ROADMAP Queue 3). B = 32 lanes,
N = 3B + 8 frames (refills and a partial last fill), k = 5.
"""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from ldpc_decoder_tpu.channels import BIAWGNChannel as JaxBIAWGN  # noqa: E402
from ldpc_decoder_tpu.codes.protographs import p41_code as jax_p41  # noqa: E402
from ldpc_decoder_tpu.runtime import params as jparams  # noqa: E402
from ldpc_decoder_tpu.runtime.datagen import create_data  # noqa: E402
from ldpc_decoder_tpu.runtime.decoder import (  # noqa: E402
    LDPCDecoder as JaxLDPCDecoder,
)

from ldpc_decoder_tpu.channels.erasure import (  # noqa: E402
    ErasureChannel as JaxErasure,
)
from ldpc_decoder_tpu.codes.qc import make_qc_code as jax_make_qc  # noqa: E402

from ldpc_decoder_tpu_torch.channels import (  # noqa: E402
    BIAWGNChannel,
    ErasureChannel,
)
from ldpc_decoder_tpu_torch.codes.qc import qc_to_code  # noqa: E402
from ldpc_decoder_tpu_torch.ops.qc_grouped import GroupedQCTables  # noqa: E402
from ldpc_decoder_tpu_torch.ops.qc_regular import QCRegularTables  # noqa: E402
from ldpc_decoder_tpu_torch.convert import structure_from_numpy  # noqa: E402
from ldpc_decoder_tpu_torch.ops import retire  # noqa: E402
from ldpc_decoder_tpu_torch.runtime.decoder import LDPCDecoder  # noqa: E402
from ldpc_decoder_tpu_torch.runtime.params import (  # noqa: E402
    DynamicParams,
    StaticParams,
)

SMALL = dict(Z=128, m=4, coarse=64, fine_mod=16)
SIGMA = 0.7
B, K = 32, 5
N = 3 * B + 8


@pytest.fixture(scope="module")
def setup():
    jcode, js = jax_p41(**SMALL)
    s = structure_from_numpy(js.Z, js.n_base_rows, js.n_base_cols,
                             js.edge_row, js.edge_col, js.edge_shift)
    code = qc_to_code(s, jcode.n_erased_vars)
    batch = create_data(jcode, JaxBIAWGN(SIGMA), 0, N, backend="numpy")
    return dict(jcode=jcode, js=js, code=code, s=s, batch=batch)


# (port channel, JAX channel); p41 runs over BI-AWGN, the regular (3,6)
# code over both
CHANNELS = {
    "awgn": (BIAWGNChannel(SIGMA), JaxBIAWGN(SIGMA)),
    "erasure": (ErasureChannel(0.3), JaxErasure(0.3)),
}


@pytest.fixture(scope="module")
def regular():
    jcode, js = jax_make_qc(np.ones((3, 6), np.int8), Z=128, seed=1)
    s = structure_from_numpy(js.Z, js.n_base_rows, js.n_base_cols,
                             js.edge_row, js.edge_col, js.edge_shift)
    batches = {name: create_data(jcode, jch, 0, N, backend="numpy")
               for name, (_, jch) in CHANNELS.items()}
    return dict(jcode=jcode, js=js, code=qc_to_code(s), s=s,
                batches=batches)


def _decode_both(setup, dtype, first_check, channel="awgn"):
    batch = setup["batch"] if "batch" in setup else setup["batches"][channel]
    ch, jch = CHANNELS[channel]
    jdec = JaxLDPCDecoder(
        setup["jcode"], jch,
        jparams.StaticParams(parallel_factor_user=B, kernel_impl="xla",
                             message_dtype=dtype),
        qc=setup["js"])
    jres, jst = jdec.decode(
        jparams.DynamicParams(num_iter_max=60, num_iter_check_parity=K,
                              num_iter_first_check=first_check),
        N, batch.values, batch.syndromes)
    dec = LDPCDecoder(setup["code"], ch,
                      StaticParams(parallel_factor_user=B,
                                   message_dtype=dtype),
                      qc=setup["s"], device="cpu")
    res, st = dec.decode(
        DynamicParams(num_iter_max=60, num_iter_check_parity=K,
                      num_iter_first_check=first_check),
        N, batch.values, batch.syndromes)
    return (res, st), (np.asarray(jres), jst)


def _bit_errors(setup, res, channel="awgn"):
    batch = setup["batch"] if "batch" in setup else setup["batches"][channel]
    return np.bitwise_count(batch.ref_bits_packed() ^ res).sum()


@pytest.mark.parametrize("first_check", [0, 10])
def test_decode_float32_matches_jax(setup, first_check):
    (res, st), (jres, jst) = _decode_both(setup, "float32", first_check)
    assert res.dtype == np.uint32 and res.shape == jres.shape
    np.testing.assert_array_equal(res, jres)
    np.testing.assert_array_equal(st.iterations, jst.iterations)
    assert st.total_supersteps == jst.total_supersteps
    assert st.total_iterations == jst.total_iterations
    assert _bit_errors(setup, res) == 0
    if first_check:
        assert st.min_iter >= first_check


def test_decode_bfloat16_matches_jax(setup):
    (res, st), (jres, jst) = _decode_both(setup, "bfloat16", 0)
    assert _bit_errors(setup, res) == 0
    assert _bit_errors(setup, jres) == 0
    assert abs(st.avg_iter - jst.avg_iter) <= K


@pytest.mark.parametrize("channel", sorted(CHANNELS))
def test_decode_regular_float32_matches_jax(regular, channel):
    """The regular family end to end: equal words and per-frame
    iterations against the JAX decoder."""
    (res, st), (jres, jst) = _decode_both(regular, "float32", 0, channel)
    np.testing.assert_array_equal(res, jres)
    np.testing.assert_array_equal(st.iterations, jst.iterations)
    assert st.total_iterations == jst.total_iterations
    assert _bit_errors(regular, res, channel) == 0


def test_decode_regular_bfloat16_decodes_all(regular):
    (res, st), (jres, jst) = _decode_both(regular, "bfloat16", 0)
    assert _bit_errors(regular, res) == 0
    assert _bit_errors(regular, jres) == 0
    assert abs(st.avg_iter - jst.avg_iter) <= K


def test_family_follows_the_base(setup, regular):
    """A regular base takes the regular kernels, p41 the grouped ones."""
    sp = StaticParams(parallel_factor_user=B)
    ch = BIAWGNChannel(SIGMA)
    dec = LDPCDecoder(regular["code"], ch, sp, qc=regular["s"], device="cpu")
    assert isinstance(dec.tables, QCRegularTables)
    dec = LDPCDecoder(setup["code"], ch, sp, qc=setup["s"], device="cpu")
    assert isinstance(dec.tables, GroupedQCTables)


def test_default_device_needs_cuda(regular, monkeypatch):
    """No device given means the card: without one the decoder raises
    instead of running on the CPU unasked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LDPCDecoder(regular["code"], BIAWGNChannel(SIGMA),
                    StaticParams(parallel_factor_user=B), qc=regular["s"])


def test_pack_bits_natural_matches_reference_packing(setup):
    code, s = setup["code"], setup["s"]
    dec = LDPCDecoder(code, BIAWGNChannel(SIGMA),
                      StaticParams(parallel_factor_user=B), qc=s,
                      device="cpu")
    ref = setup["batch"].ref_bits[:, :B]  # natural order, bit 31 included
    t = dec.tables
    sorted_bits = torch.from_numpy(ref[t.vn_order.numpy()].copy())
    packed = torch.zeros((B, dec.n_words), dtype=torch.int32)
    retire.pack_retired(sorted_bits.view(t.C, t.Z, B), dec._src_row,
                        np.arange(B), np.arange(B), packed)
    np.testing.assert_array_equal(
        packed.numpy().view(np.uint32),
        setup["batch"].ref_bits_packed()[:B])


def _retire_decoder(setup, regular, layout):
    """A CPU decoder of each retire layout: block-aligned QC (the p41-shaped
    code), interleaved QC (the regular code renumbered) and the general
    path on a code whose n_vars is no multiple of 32."""
    from ldpc_decoder_tpu_torch.codes.generate import make_regular_code
    from ldpc_decoder_tpu_torch.codes.qc import interleave_code_numbering

    ch, sp = BIAWGNChannel(SIGMA), StaticParams(parallel_factor_user=B)
    if layout == "aligned":
        return LDPCDecoder(setup["code"], ch, sp, qc=setup["s"],
                           device="cpu")
    if layout == "interleaved":
        icode = interleave_code_numbering(regular["code"], regular["s"].Z)[0]
        return LDPCDecoder(icode, ch, sp, device="cpu")
    return LDPCDecoder(make_regular_code(1002, 3, 6, seed=4), ch, sp,
                       device="cpu")


def _pack_rows_route(dec, bits):
    """The retire's words as the decoder packed them before the retire
    kernel: whole Z-blocks permuted where the numbering is block-aligned,
    else a row gather, then ``pack_rows``."""
    from ldpc_decoder_tpu_torch.rng.chacha_torch import pack_rows

    n = bits.shape[-1]
    vn_pos = dec._src_row.numpy()
    if dec.qc is not None:
        Z = dec.qc.Z
        perm = vn_pos[::Z] // Z
        if np.array_equal(vn_pos.reshape(-1, Z),
                          perm[:, None] * Z + np.arange(Z)):
            rows = bits.reshape(-1, Z, n)[torch.from_numpy(perm)]
            return pack_rows(rows.reshape(-1, n), dec.n_words)
    return pack_rows(bits.reshape(-1, n).index_select(
        0, torch.from_numpy(vn_pos).long()), dec.n_words)


@pytest.mark.parametrize("lanes", ["one", "shuffled subset", "all"])
@pytest.mark.parametrize("layout", ["aligned", "interleaved", "general"])
def test_pack_retired_matches_the_pack_rows_route(setup, regular, layout,
                                                  lanes):
    """The retire's plain version (``ops/retire.py``, what a CPU decode and
    the card's kernel are held to) against the decoder's former route:
    the same words in the named frames' rows, frame ids out of order, the
    last word's bits past n_vars zero, and the rows no lane names left as
    they were."""
    dec = _retire_decoder(setup, regular, layout)
    if layout != "general":  # whole Z-blocks in order, or interleaved
        vn_pos = dec._src_row.numpy().reshape(-1, dec.qc.Z)
        assert (vn_pos == vn_pos[:, :1] + np.arange(dec.qc.Z)).all() == (
            layout == "aligned")
    if layout == "general":
        assert dec.qc is None and dec.code.n_vars % 32
    rng = np.random.default_rng(11)
    shape = (*dec._node_shape[0], B)
    bits = torch.from_numpy((rng.random(shape) < 0.5).astype(np.int8))
    lane_ids = {"one": np.array([B - 3]),
                "shuffled subset": rng.permutation(B)[:B // 3],
                "all": np.arange(B)}[lanes]
    n_pool = 3 * B
    frames = rng.permutation(n_pool)[:lane_ids.size]
    results = torch.from_numpy(rng.integers(-2**31, 2**31, (
        n_pool, dec.n_words), dtype=np.int64).astype(np.int32))
    want = results.clone()
    want[torch.from_numpy(frames)] = _pack_rows_route(
        dec, bits[..., torch.from_numpy(lane_ids)])
    retire.pack_retired(bits, dec._src_row, lane_ids, frames, results)
    assert torch.equal(results, want)
    tail = dec.n_words * 32 - dec.code.n_vars
    if tail:  # the last word's bits past n_vars are zero
        last = results[torch.from_numpy(frames), -1].numpy().view(np.uint32)
        assert not (last >> np.uint32(32 - tail)).any()
    np.testing.assert_array_equal(  # and the decoder's own route agrees
        dec._pack(bits[..., torch.from_numpy(lane_ids)]).numpy(),
        want[torch.from_numpy(frames)].numpy())


def test_pack_retired_refuses_what_it_cannot_write(setup):
    dec = _retire_decoder(setup, None, "aligned")
    bits = torch.zeros((*dec._node_shape[0], B), dtype=torch.int8)
    results = torch.zeros((4, dec.n_words), dtype=torch.int32)
    for lanes, frames in (([B], [0]), ([0], [4]), ([1, 1], [0, 2]),
                          ([0, 1], [2, 2]), ([0, 1], [0])):
        with pytest.raises(ValueError):
            retire.pack_retired(bits, dec._src_row, lanes, frames, results)
    with pytest.raises(ValueError, match="results"):
        retire.pack_retired(bits, dec._src_row, [0], [0], results[:, 1:])


def test_lane_count_model(setup):
    code, s = setup["code"], setup["s"]
    ch = BIAWGNChannel(SIGMA)
    with pytest.raises(ValueError, match="device_memory_bytes"):
        LDPCDecoder(code, ch, StaticParams(), qc=s, device="cpu")
    dec = LDPCDecoder(code, ch, StaticParams(
        device_memory_bytes=16 << 30, max_log_parallel_factor_user=8),
        qc=s, device="cpu")
    assert dec.parallel_factor() == 256
    dec = LDPCDecoder(code, ch, StaticParams(device_memory_bytes=1 << 20),
                      qc=s, device="cpu")
    assert dec.parallel_factor() & (dec.parallel_factor() - 1) == 0
    assert dec.parallel_factor() < 32


@pytest.mark.parametrize("kw", [
    dict(kernel_impl="xla"),
    dict(kernel_impl="pallas"),
])
def test_options_not_ported_raise(kw):
    with pytest.raises(NotImplementedError):
        StaticParams(**kw)


def test_int8_needs_minsum():
    """int8 is fixed-point min-sum storage, as in the JAX package."""
    with pytest.raises(ValueError, match="min-sum"):
        StaticParams(message_dtype="int8")


# (fixture, StaticParams of both decoders, declared structure or detection)
MINSUM_CASES = {
    "regular-bf16-detected": ("regular", dict(message_dtype="bfloat16"),
                              False),
    "regular-int8": ("regular", dict(message_dtype="int8"), True),
    "p41-int8-alpha-table-detected": (
        "setup", dict(message_dtype="int8", minsum_offset=0.0,
                      minsum_alpha={3: 0.8, 6: 0.75, 7: 0.75, 0: 0.8}),
        False),
    "p41-f32-alpha-table": (
        "setup", dict(message_dtype="float32", minsum_offset=0.0,
                      minsum_alpha={6: 0.8125, 0: 0.875}), True),
}


@pytest.mark.parametrize("case", sorted(MINSUM_CASES))
def test_decode_minsum_matches_jax(setup, regular, case):
    """QC min-sum end to end against the JAX decoder: regular-base bf16
    (the regular family), int8 on a regular base (routed to the grouped
    family, as in JAX), and the irregular p41 base with a per-degree α
    table; built from the plain code by detection, or with ``qc=``."""
    fixture, kw, declared = MINSUM_CASES[case]
    st = setup if fixture == "setup" else regular
    batch = st["batch"] if "batch" in st else st["batches"]["awgn"]
    ch, jch = CHANNELS["awgn"]
    dyn = dict(num_iter_max=40, num_iter_check_parity=K)
    jdec = JaxLDPCDecoder(
        st["jcode"], jch, jparams.StaticParams(
            parallel_factor_user=B, algorithm="min-sum", **kw),
        qc=st["js"] if declared else None)
    jres, jst = jdec.decode(jparams.DynamicParams(**dyn), N, batch.values,
                            batch.syndromes)
    dec = LDPCDecoder(st["code"], ch, StaticParams(
        parallel_factor_user=B, algorithm="min-sum", **kw),
        qc=st["s"] if declared else None, device="cpu")
    assert dec.qc is not None
    want = (QCRegularTables if fixture == "regular"
            and kw["message_dtype"] != "int8" else GroupedQCTables)
    assert isinstance(dec.tables, want)
    res, stats = dec.decode(DynamicParams(**dyn), N, batch.values,
                            batch.syndromes)
    np.testing.assert_array_equal(res, np.asarray(jres))
    np.testing.assert_array_equal(stats.iterations, jst.iterations)
    assert stats.total_iterations == jst.total_iterations
    assert stats.total_supersteps > 3  # refills ran


def test_lane_count_model_counts_message_bytes(regular):
    """int8 messages take one byte each in the lane model, bf16 two and
    float32 four: over a sweep of memory sizes the lane counts never fall
    as the message shrinks, and each step gains lanes somewhere."""
    code, ch = regular["code"], BIAWGNChannel(SIGMA)
    lanes = {dt: [] for dt in ("float32", "bfloat16", "int8")}
    for mem in np.geomspace(2**22, 2**30, 40).astype(np.int64):
        for dt in lanes:
            lanes[dt].append(LDPCDecoder(code, ch, StaticParams(
                algorithm="min-sum", message_dtype=dt,
                device_memory_bytes=int(mem),
                max_log_parallel_factor_user=30), device="cpu"
            ).parallel_factor())
    f32, bf16, i8 = (np.array(lanes[dt]) for dt in lanes)
    assert (f32 <= bf16).all() and (bf16 <= i8).all()
    assert (f32 < bf16).any() and (bf16 < i8).any()


# ---- the JAX decoder's signatures and host-poll clock -------------------------

def _general_codes():
    """tests/test_runtime.py's small_code, from both packages."""
    from ldpc_decoder_tpu.codes.generate import make_regular_code as jmake
    from ldpc_decoder_tpu_torch.codes.generate import make_regular_code

    return jmake(512, 3, 6, seed=21), make_regular_code(512, 3, 6, seed=21)


@pytest.mark.parametrize("family", ["general", "regular"])
def test_decode_input_is_llr_positional_matches_jax(regular, family):
    """The fifth argument is input_is_llr, as in JAX (tests/test_runtime.py:
    207): a positional True decodes LLRs to the raw values' words, on the
    port as on the JAX decoder; 3B frames, so refilled lanes take LLRs
    too."""
    n_lanes = 8 if family == "general" else B
    n = 3 * n_lanes
    dyn = dict(num_iter_max=60, num_iter_check_parity=5)
    if family == "general":
        jcode, code = _general_codes()
        ch, jch = BIAWGNChannel(0.65), JaxBIAWGN(0.65)
        batch = create_data(jcode, jch, 0, n, backend="numpy")
        kw, jkw = dict(qc_autodetect=False), {}
    else:
        jcode, code = regular["jcode"], regular["code"]
        ch, jch = CHANNELS["awgn"]
        batch = create_data(jcode, jch, 0, n, backend="numpy")
        kw, jkw = dict(message_dtype="float32"), dict(
            message_dtype="float32", kernel_impl="xla")
    llrs = jch.llr_np(batch.values)
    jdec = JaxLDPCDecoder(jcode, jch, jparams.StaticParams(
        parallel_factor_user=n_lanes, **jkw),
        qc=regular["js"] if family == "regular" else None)
    jres, _ = jdec.decode(jparams.DynamicParams(**dyn), n, llrs,
                          batch.syndromes, True)
    dec = LDPCDecoder(code, ch, StaticParams(parallel_factor_user=n_lanes,
                                             **kw),
                      qc=regular["s"] if family == "regular" else None,
                      device="cpu")
    assert not dec.decoding_input_is_llr()
    res_raw, _ = dec.decode(DynamicParams(**dyn), n, batch.values,
                            batch.syndromes)
    res_llr, st = dec.decode(DynamicParams(**dyn), n, llrs, batch.syndromes,
                             True)
    assert st.total_supersteps >= 3  # two refills ran
    np.testing.assert_array_equal(res_llr, res_raw)
    np.testing.assert_array_equal(res_llr, np.asarray(jres))
    assert np.bitwise_count(batch.ref_bits_packed() ^ res_llr).sum() == 0


SLOW_START = 0.5  # seconds the patched _start sleeps


@pytest.mark.parametrize("host_poll", [True, False])
def test_decode_clock_follows_host_poll(regular, monkeypatch, host_poll):
    """decode_presorted's fifth argument is host_poll and its sixth
    progress, as in JAX; the host-poll clock starts after the lanes' first
    load and init (JAX's host-polled loop), the other one before them
    (JAX's fused loop)."""
    ch = CHANNELS["awgn"][0]
    dec = LDPCDecoder(regular["code"], ch, StaticParams(
        parallel_factor_user=B, message_dtype="float32"), qc=regular["s"],
        device="cpu")
    batch = regular["batches"]["awgn"]
    pv, ps = dec.upload_pools(batch.values[:, :B], batch.syndromes[:, :B])
    start = dec._start

    def slow_start(*args, **kw):
        time.sleep(SLOW_START)
        return start(*args, **kw)

    monkeypatch.setattr(dec, "_start", slow_start)
    seen = []
    res, st = dec.decode_presorted(
        DynamicParams(num_iter_max=40, num_iter_check_parity=K), B, pv, ps,
        host_poll, seen.append)
    assert seen and seen[-1] == 0
    assert (st.elapsed_seconds < SLOW_START) == host_poll, st.elapsed_seconds
    assert np.bitwise_count(batch.ref_bits_packed()[:B] ^ res).sum() == 0


def test_fetch_results_false_leaves_results_on_the_device(regular):
    ch = CHANNELS["awgn"][0]
    dec = LDPCDecoder(regular["code"], ch, StaticParams(
        parallel_factor_user=B), qc=regular["s"], device="cpu")
    batch = regular["batches"]["awgn"]
    pv, ps = dec.upload_pools(batch.values, batch.syndromes)
    dyn = DynamicParams(num_iter_max=40, num_iter_check_parity=K)
    on_dev, st = dec.decode_presorted(dyn, N, pv, ps, fetch_results=False)
    assert isinstance(on_dev, torch.Tensor) and on_dev.device == dec.device
    assert on_dev.shape == (N, dec.n_words) and on_dev.dtype == torch.int32
    res, _ = dec.decode_presorted(dyn, N, pv, ps)
    np.testing.assert_array_equal(on_dev.numpy().view(np.uint32), res)


def test_set_erased_variables_matches_jax():
    """JAX's tests/test_runtime.py::test_set_erased_variables on the port,
    held to the JAX decoder after the same call: the erased mask in natural
    order, ``n_erased_vars``, and the decode of the same frames (the
    trailing 32 variables' channel values 0) to the same words and
    per-frame iterations, without error."""
    from ldpc_decoder_tpu.codes.generate import make_regular_code as jmake

    from ldpc_decoder_tpu_torch.codes.generate import make_regular_code

    jdec = JaxLDPCDecoder(jmake(512, 3, 6, seed=6), JaxBIAWGN(0.55),
                          jparams.StaticParams(max_log_parallel_factor_user=3))
    dec = LDPCDecoder(make_regular_code(512, 3, 6, seed=6),
                      BIAWGNChannel(0.55), StaticParams(
                          max_log_parallel_factor_user=3,
                          device_memory_bytes=1 << 30), device="cpu")
    jdec.set_erased_variables(32)
    dec.set_erased_variables(32)
    assert dec.code.n_erased_vars == jdec.code.n_erased_vars == 32

    def natural(mask, order):
        out = np.empty(mask.shape[0], bool)
        out[np.asarray(order)] = np.asarray(mask)[:, 0]
        return out

    mask = natural(dec.tables.erased_mask_sorted.numpy(), dec._vn_order_io)
    np.testing.assert_array_equal(mask, natural(
        jdec.tables.erased_mask_sorted, jdec._vn_order_io))
    assert mask[-32:].all() and not mask[:-32].any()
    n = dec.parallel_factor()
    assert n == jdec.parallel_factor()
    batch = create_data(jdec.code, JaxBIAWGN(0.55), 0, n)
    assert (batch.values[-32:] == 0.0).all()
    dyn = dict(num_iter_max=60, num_iter_check_parity=5, loading_factor=1)
    res, st = dec.decode(DynamicParams(**dyn), n, batch.values,
                         batch.syndromes)
    jres, jst = jdec.decode(jparams.DynamicParams(**dyn), n, batch.values,
                            batch.syndromes)
    np.testing.assert_array_equal(res, np.asarray(jres))
    np.testing.assert_array_equal(st.iterations, jst.iterations)
    assert np.bitwise_count(batch.ref_bits_packed() ^ res).sum() == 0
    dec.set_erased_variables(0)
    assert not dec.tables.erased_mask_sorted.any()
    with pytest.raises(ValueError, match="outside"):
        dec.set_erased_variables(513)


def test_bsc_harness_matches_jax():
    """A BSC decode end to end, held to the JAX decoder: JAX's
    tests/test_runtime.py::test_bsc_end_to_end_harness through the port's
    harness on the CPU gives the JAX harness's report (errors, frames in
    error, iterations)."""
    import io

    from ldpc_decoder_tpu.channels import BSCChannel as JaxBSC
    from ldpc_decoder_tpu.codes.generate import make_regular_code as jmake
    from ldpc_decoder_tpu.runtime.harness import do_test as jax_do_test

    from ldpc_decoder_tpu_torch.channels import BSCChannel
    from ldpc_decoder_tpu_torch.codes.generate import make_regular_code
    from ldpc_decoder_tpu_torch.runtime.harness import do_test

    dyn = dict(num_iter_max=50, loading_factor=2, target_errors=15)
    jrep = jax_do_test(jmake(512, 3, 6, seed=21), JaxBSC(0.02), num_runs=2,
                       static_params=jparams.StaticParams(
                           max_log_parallel_factor_user=3),
                       dyn_params=jparams.DynamicParams(**dyn),
                       start_index=0, log_level=0, out=io.StringIO())
    code, ch = make_regular_code(512, 3, 6, seed=21), BSCChannel(0.02)
    sp = StaticParams(max_log_parallel_factor_user=3,
                      device_memory_bytes=1 << 30)
    out = io.StringIO()
    rep = do_test(code, ch, 2, sp, DynamicParams(**dyn), start_index=0,
                  log_level=3, out=out,
                  decoder=LDPCDecoder(code, ch, sp, device="cpu"))
    assert rep.num_bit_errors == jrep.num_bit_errors == 0
    assert rep.vectors_with_errors == jrep.vectors_with_errors == 0
    for f in ("num_vectors_per_run", "avg_iter", "min_iter", "max_iter"):
        assert getattr(rep, f) == getattr(jrep, f), f
    assert "Decoding throughput:" in rep.report
    assert "frame batch 1 / 2" in out.getvalue()
