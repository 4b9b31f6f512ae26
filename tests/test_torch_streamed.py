"""``LDPCDecoder.decode_streamed``, the host-fed pipeline, on the CPU.

Held against the JAX package's ``decode_streamed`` on its own test's setup
(``tests/test_runtime.py``: ``make_regular_code(512, 3, 6, seed=21)``,
BI-AWGN 0.65, ``max_log_parallel_factor_user=3``, 3 chunks of 2B; the JAX
side on its Pallas general kernels in interpret mode, float32 messages),
and against the port's own per-chunk ``decode()`` on the grouped QC, the
regular QC and the general families, every pipeline depth, channel values
and LLRs, and uneven chunks. Also: the order in which chunks are taken and
yielded, yielded arrays that outlive the stream, bad chunks, errors of the
iterator and of the worker, the worker joined on close, and the staging
route's permutation against numpy's. Tolerance: exact throughout (words,
per-frame iterations, pool bits).
"""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from ldpc_decoder_tpu.channels import BIAWGNChannel as JaxBIAWGN  # noqa: E402
from ldpc_decoder_tpu.codes.generate import (  # noqa: E402
    make_regular_code as jmake_regular,
)
from ldpc_decoder_tpu.runtime import params as jparams  # noqa: E402
from ldpc_decoder_tpu.runtime.datagen import (  # noqa: E402
    create_data as jcreate_data,
)
from ldpc_decoder_tpu.runtime.decoder import (  # noqa: E402
    LDPCDecoder as JaxLDPCDecoder,
)

from ldpc_decoder_tpu_torch.channels import BIAWGNChannel  # noqa: E402
from ldpc_decoder_tpu_torch.codes.generate import (  # noqa: E402
    make_regular_code,
)
from ldpc_decoder_tpu_torch.codes.protographs import p41_code  # noqa: E402
from ldpc_decoder_tpu_torch.codes.qc import make_qc_code  # noqa: E402
from ldpc_decoder_tpu_torch.ops.general import GeneralTables  # noqa: E402
from ldpc_decoder_tpu_torch.ops.qc_grouped import GroupedQCTables  # noqa: E402
from ldpc_decoder_tpu_torch.ops.qc_regular import QCRegularTables  # noqa: E402
from ldpc_decoder_tpu_torch.runtime.datagen import create_data  # noqa: E402
from ldpc_decoder_tpu_torch.runtime.decoder import (  # noqa: E402
    STAGE_SPLIT_BYTES,
    STREAM_THREAD,
    LDPCDecoder,
    _copy_into,
)
from ldpc_decoder_tpu_torch.runtime.params import (  # noqa: E402
    DynamicParams,
    StaticParams,
)

SIGMA = 0.7
B = 16
# uneven chunks: two fills, one under B, one refilling, the last smaller
CHUNKS = (2 * B, B - 3, B + 5, 7)
DYN = DynamicParams(num_iter_max=60, num_iter_check_parity=5,
                    num_iter_first_check=7)


def _family(name):
    """(code, qc structure or None, expected tables) of a small code."""
    if name == "grouped":
        code, s = p41_code(Z=128, m=4, coarse=64, fine_mod=16)
        return code, s, GroupedQCTables
    if name == "regular":
        code, s = make_qc_code(np.ones((3, 6), np.int8), Z=64, seed=1)
        return code, s, QCRegularTables
    return make_regular_code(512, 3, 6, seed=21), None, GeneralTables


@pytest.fixture(scope="module")
def families():
    """Per family: the decoder, its natural-order chunks (channel values
    and their LLRs) and the reference bits, built once."""
    out = {}
    ch = BIAWGNChannel(SIGMA)
    for name in ("grouped", "regular", "general"):
        code, s, tables = _family(name)
        dec = LDPCDecoder(code, ch, StaticParams(
            parallel_factor_user=B, qc_autodetect=False), qc=s, device="cpu")
        assert isinstance(dec.tables, tables)
        batch = create_data(code, ch, 0, sum(CHUNKS), backend="numpy")
        llr = ch.llr_from_channel(torch.from_numpy(batch.values)).numpy()
        edges = np.cumsum((0,) + CHUNKS)
        chunks = {}
        for is_llr, vals in ((False, batch.values), (True, llr)):
            chunks[is_llr] = [(vals[:, a:b], batch.syndromes[:, a:b])
                              for a, b in zip(edges[:-1], edges[1:])]
        out[name] = dict(dec=dec, chunks=chunks, serial={},
                         ref=batch.ref_bits_packed(), edges=edges)
    return out


def _serial(fam, input_is_llr):
    """Per-chunk decode() of the family's chunks, computed once."""
    if input_is_llr not in fam["serial"]:
        fam["serial"][input_is_llr] = [
            fam["dec"].decode(DYN, v.shape[1], v, s,
                              input_is_llr=input_is_llr)
            for v, s in fam["chunks"][input_is_llr]]
    return fam["serial"][input_is_llr]


def _stream_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith(STREAM_THREAD)]


# ---- against the JAX package ------------------------------------------------

def test_streamed_matches_jax_streamed():
    """The JAX package's own decode_streamed test setup: words and
    per-frame iterations equal, chunk by chunk, float32 messages."""
    jcode = jmake_regular(512, 3, 6, seed=21)
    jch = JaxBIAWGN(0.65)
    jdec = JaxLDPCDecoder(jcode, jch, jparams.StaticParams(
        max_log_parallel_factor_user=3, kernel_impl="pallas",
        qc_autodetect=False, message_dtype="float32"))
    b = jdec.parallel_factor()
    n_chunk = 2 * b
    batches = [jcreate_data(jcode, jch, i * n_chunk, n_chunk,
                            backend="numpy") for i in range(3)]
    chunks = [(x.values, x.syndromes) for x in batches]
    jdyn = jparams.DynamicParams(num_iter_max=60, num_iter_check_parity=5,
                                 loading_factor=2)
    jout = list(jdec.decode_streamed(jdyn, iter(chunks)))

    dec = LDPCDecoder(make_regular_code(512, 3, 6, seed=21),
                      BIAWGNChannel(0.65),
                      StaticParams(parallel_factor_user=b,
                                   qc_autodetect=False,
                                   message_dtype="float32"), device="cpu")
    dyn = DynamicParams(num_iter_max=60, num_iter_check_parity=5,
                        loading_factor=2)
    out = list(dec.decode_streamed(dyn, iter(chunks)))
    assert len(out) == len(jout) == 3
    for (res, st), (jres, jst), x in zip(out, jout, batches):
        assert res.dtype == np.uint32 and res.shape == (n_chunk, dec.n_words)
        np.testing.assert_array_equal(res, np.asarray(jres))
        np.testing.assert_array_equal(st.iterations, np.asarray(
            jst.iterations))
        assert st.total_iterations == jst.total_iterations
        assert np.bitwise_count(x.ref_bits_packed() ^ res).sum() == 0


# ---- against the port's serial decode() -------------------------------------

@pytest.mark.parametrize("input_is_llr", [False, True])
@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("family", ["grouped", "regular", "general"])
def test_streamed_matches_serial(families, family, depth, input_is_llr):
    fam = families[family]
    serial = _serial(fam, input_is_llr)
    out = list(fam["dec"].decode_streamed(
        DYN, iter(fam["chunks"][input_is_llr]), input_is_llr=input_is_llr,
        depth=depth))
    assert len(out) == len(CHUNKS)
    edges = fam["edges"]
    for i, ((res, st), (sres, sst)) in enumerate(zip(out, serial)):
        assert res.dtype == np.uint32 and res.shape == sres.shape
        np.testing.assert_array_equal(res, sres)
        np.testing.assert_array_equal(st.iterations, sst.iterations)
        assert st.total_supersteps == sst.total_supersteps
        assert st.total_iterations == sst.total_iterations
        assert st.batch_size == B and st.events is None
        assert 0.0 < st.decode_seconds <= st.elapsed_seconds
        np.testing.assert_array_equal(res, fam["ref"][edges[i]:edges[i + 1]])
    assert not _stream_threads()


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_submission_order(families, depth):
    """Chunk i is yielded only after chunk i + depth - 1 was taken from the
    iterator (JAX's order); depth 1 is strictly serial."""
    fam = families["regular"]
    order = []

    def chunks():
        for i, c in enumerate(fam["chunks"][False]):
            order.append(("submit", i))
            yield c

    for i, _ in enumerate(fam["dec"].decode_streamed(DYN, chunks(),
                                                     depth=depth)):
        order.append(("yield", i))
    n = len(CHUNKS)
    want = []
    for i in range(n):
        want.append(("submit", i))
        if i >= depth - 1:
            want.append(("yield", i - depth + 1))
    want += [("yield", i) for i in range(max(n - depth + 1, 0), n)]
    assert order == want


def test_yielded_arrays_are_fresh(families):
    """Arrays kept until the stream ends still hold their chunk's words,
    and no two share memory."""
    fam = families["grouped"]
    kept = [res for res, _ in fam["dec"].decode_streamed(
        DYN, iter(fam["chunks"][False]), depth=2)]
    for res, (sres, _) in zip(kept, _serial(fam, False)):
        np.testing.assert_array_equal(res, sres)
    for i in range(len(kept)):
        for j in range(i):
            assert not np.shares_memory(kept[i], kept[j])


# ---- errors and shutdown ----------------------------------------------------

def test_depth_must_be_positive(families):
    gen = families["regular"]["dec"].decode_streamed(DYN, iter([]), depth=0)
    with pytest.raises(ValueError, match="depth"):
        next(gen)


@pytest.mark.parametrize("bad", ["values rows", "syndrome frames",
                                 "values 1-D", "no frames"])
def test_bad_chunk_shape_raises(families, bad):
    fam = families["regular"]
    dec = fam["dec"]
    v, s = fam["chunks"][False][0]
    v, s = {"values rows": (v[:-1], s),
            "syndrome frames": (v, s[:, :-1]),
            "values 1-D": (v[:, 0], s[:, 0]),
            "no frames": (v[:, :0], s[:, :0])}[bad]
    good = fam["chunks"][False][1]
    gen = dec.decode_streamed(DYN, iter([good, (v, s)]))
    with pytest.raises(ValueError, match="chunk"):
        list(gen)
    assert not _stream_threads()


def test_iterator_error_reaches_the_consumer(families):
    fam = families["regular"]

    def chunks():
        yield fam["chunks"][False][0]
        raise KeyError("frame source failed")

    gen = fam["dec"].decode_streamed(DYN, chunks())
    with pytest.raises(KeyError, match="frame source failed"):
        list(gen)
    assert not _stream_threads()


def test_worker_error_reaches_the_consumer(families, monkeypatch):
    """An exception in the worker's decode surfaces where the consumer
    takes that chunk; the earlier chunks come out first, and the stream
    does not carry on."""
    fam = families["regular"]
    dec = fam["dec"]
    real = dec.decode_presorted
    calls = []

    def failing(*args, **kw):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("injected decode failure")
        return real(*args, **kw)

    monkeypatch.setattr(dec, "decode_presorted", failing)
    gen = dec.decode_streamed(DYN, iter(fam["chunks"][False]), depth=2)
    res, _ = next(gen)
    np.testing.assert_array_equal(res, _serial(fam, False)[0][0])
    with pytest.raises(RuntimeError, match="injected decode failure"):
        next(gen)
    assert not _stream_threads()
    assert len(calls) <= 3


@pytest.mark.parametrize("how", ["close", "break"])
def test_close_joins_the_worker(families, how):
    fam = families["regular"]
    gen = fam["dec"].decode_streamed(DYN, iter(fam["chunks"][False]),
                                     depth=3)
    if how == "close":
        next(gen)
        assert _stream_threads()
        gen.close()
    else:
        for _ in gen:
            break
        del gen
    assert not _stream_threads()


# ---- the staging route ------------------------------------------------------

@pytest.mark.parametrize("family", ["grouped", "regular", "general"])
def test_upload_pools_permutation_matches_numpy(families, family):
    """The route's row gather against numpy's fancy indexing, bit for bit:
    float32 with NaN payloads, signed zeros, subnormals and infinities,
    float64 values cast as astype casts them, and 0/1 syndromes given as
    bool and as int64."""
    dec = families[family]["dec"]
    rng = np.random.default_rng(3)
    nv, nc, n = dec.code.n_vars, dec.code.n_checks, 11
    bits = rng.integers(0, 2**32, (nv, n), dtype=np.uint64).astype(np.uint32)
    bits[:4, 0] = [0x7FC01234, 0x80000000, 0x00000001, 0xFF800000]
    syn = rng.random((nc, n)) < 0.5
    vn, cn = dec._vn_order_io, dec._cn_order_io
    with np.errstate(invalid="ignore"):  # signalling NaNs widen quietly
        wide = bits.view(np.float32).astype(np.float64)
    for values, syndromes in ((bits.view(np.float32), syn),
                              (wide, syn.astype(np.int64))):
        pv, ps = dec.upload_pools(values, syndromes)
        want_v = values[vn].astype(np.float32)
        want_s = syndromes[cn].astype(np.int8)
        assert pv.dtype == torch.float32 and ps.dtype == torch.int8
        np.testing.assert_array_equal(pv.numpy().view(np.uint32),
                                      want_v.view(np.uint32))
        np.testing.assert_array_equal(ps.numpy(), want_s)


@pytest.mark.parametrize("rows, split", [(7, True), (1 << 12, True),
                                         (5, False)])
def test_split_staging_copy_matches_copyto(rows, split):
    """The pinned copy split over threads casts as one np.copyto does
    (float64 to float32 from a strided view, bool to int8), above and
    below the split size, and joins its threads."""
    rng = np.random.default_rng(4)
    cols = STAGE_SPLIT_BYTES // 4 // rows + 3 if split else 10
    src = rng.standard_normal((rows, 2 * cols))[:, ::2]
    dst = np.empty((rows, cols), np.float32)
    _copy_into(dst, src)
    np.testing.assert_array_equal(dst, src.astype(np.float32))
    flags = rng.random((rows, cols)) < 0.5
    out = np.empty((rows, cols), np.int8)
    _copy_into(out, flags)
    np.testing.assert_array_equal(out, flags.astype(np.int8))
    assert not _stream_threads()
