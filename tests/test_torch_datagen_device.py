"""The port's pool generation (``rng/chacha_torch.py``,
``runtime/datagen_device.py``) against the JAX package's
(``rng/chacha_jax.py``, ``runtime/datagen_device.py``), on the CPU.

Tolerances: ChaCha8 words, reference bits, packed words, BSC and erasure
values, syndromes and error counts are exact. BI-AWGN values go through
log and cos, which XLA:CPU and torch's CPU kernels round differently (a
few float32 ulps; XLA may also fuse tx + sigma * g into one multiply-add),
so they are held within AWGN_ATOL absolute, and to the same statistics as
JAX's own test; their bits, syndromes and packed words stay exact. The
card's kernels are held bit for bit to the plain versions in
``tests/test_torch_cuda.py``.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from ldpc_decoder_tpu.channels import BIAWGNChannel as JaxAwgn  # noqa: E402
from ldpc_decoder_tpu.channels import BSCChannel as JaxBSC  # noqa: E402
from ldpc_decoder_tpu.channels.erasure import (  # noqa: E402
    ErasureChannel as JaxErasure,
)
from ldpc_decoder_tpu.codes import qc as jqc  # noqa: E402
from ldpc_decoder_tpu.codes.generate import (  # noqa: E402
    make_regular_code as jax_make_regular,
)
from ldpc_decoder_tpu.codes.protographs import p41_code as jax_p41  # noqa: E402
from ldpc_decoder_tpu.codes.protographs import (  # noqa: E402
    regular_base as jax_regular_base,
)
from ldpc_decoder_tpu.rng import chacha_jax as cj  # noqa: E402
from ldpc_decoder_tpu.runtime import datagen_device as jdd  # noqa: E402
from ldpc_decoder_tpu.runtime import params as jparams  # noqa: E402
from ldpc_decoder_tpu.runtime.decoder import (  # noqa: E402
    LDPCDecoder as JaxLDPCDecoder,
)

from ldpc_decoder_tpu_torch.channels import (  # noqa: E402
    BIAWGNChannel,
    BSCChannel,
    ErasureChannel,
)
from ldpc_decoder_tpu_torch.codes.alist import AlistData  # noqa: E402
from ldpc_decoder_tpu_torch.codes.code import LDPCCode  # noqa: E402
from ldpc_decoder_tpu_torch.codes.qc import qc_to_code  # noqa: E402
from ldpc_decoder_tpu_torch.convert import structure_from_numpy  # noqa: E402
from ldpc_decoder_tpu_torch.ops.general import GeneralTables  # noqa: E402
from ldpc_decoder_tpu_torch.ops.qc_grouped import GroupedQCTables  # noqa: E402
from ldpc_decoder_tpu_torch.ops.qc_regular import QCRegularTables  # noqa: E402
from ldpc_decoder_tpu_torch.rng import chacha_torch as ct  # noqa: E402
from ldpc_decoder_tpu_torch.runtime import datagen_device as dd  # noqa: E402
from ldpc_decoder_tpu_torch.runtime import perf  # noqa: E402
from ldpc_decoder_tpu_torch.runtime.datagen import (  # noqa: E402
    create_data,
    generate_reference_bits,
)
from ldpc_decoder_tpu_torch.runtime.decoder import LDPCDecoder  # noqa: E402
from ldpc_decoder_tpu_torch.runtime.params import (  # noqa: E402
    DynamicParams,
    StaticParams,
)

GOLDEN = os.path.join(os.path.dirname(__file__), "data", "chacha_golden.txt")
AWGN_ATOL = 1e-5
M32 = 0xFFFFFFFF
# a start index whose seeds wrap past 2^32 within a pool
WRAP = 2**32 - 40


def _golden():
    with open(GOLDEN) as f:
        for line in f:
            seed, iv, first, last = line.split()
            yield int(seed), int(iv), bytes.fromhex(first), bytes.fromhex(last)


def _seeds(seeds):
    """[2, m] lo/hi int64 of Python int seeds."""
    return torch.tensor([[s & M32 for s in seeds], [s >> 32 for s in seeds]],
                        dtype=torch.int64)


def _u32(t):
    return t.numpy().astype(np.uint32)


# ---- ChaCha8 ----------------------------------------------------------------

def test_stream_words_2d_matches_jax():
    """Seeds with and without the 2^32 flag; a partial last block."""
    seeds = [5, 6, 7 + (1 << 32), 2**32 - 1 + (1 << 32)]
    words = ct.stream_words_2d(_seeds(seeds), 803)
    jwords = cj.stream_words_2d(
        jnp.asarray(_seeds(seeds).numpy().astype(np.uint32)), 803)
    np.testing.assert_array_equal(_u32(words), np.asarray(jwords))


@pytest.mark.parametrize("seed,iv,first,last", list(_golden()))
def test_stream_words_2d_matches_golden(seed, iv, first, last):
    """The reference's keystream bytes: the first and last block of refill
    ``iv`` (seeds above 2^32 included)."""
    words = _u32(ct.stream_words_2d(_seeds([seed]), 384 * (iv + 1))[0])
    assert words[384 * iv:384 * iv + 16].tobytes() == first
    assert words[384 * iv + 368:384 * iv + 384].tobytes() == last


def test_chacha8_blocks_matches_jax():
    rng = np.random.default_rng(3)
    key = rng.integers(0, 2**32, (2, 50), dtype=np.uint64).astype(np.int64)
    ctr = rng.integers(0, 24, 50)
    nonce = rng.integers(0, 2**32, 50, dtype=np.uint64).astype(np.int64)
    got = ct.chacha8_blocks(torch.from_numpy(key), torch.from_numpy(ctr),
                            torch.from_numpy(nonce))
    want = cj.chacha8_blocks(jnp.asarray(key.astype(np.uint32)),
                             jnp.asarray(ctr.astype(np.uint32)),
                             jnp.asarray(nonce.astype(np.uint32)))
    np.testing.assert_array_equal(_u32(got), np.asarray(want))


@pytest.mark.parametrize("seed", [0, 5, 11])
def test_chacha_op_model_folds_to_the_block(seed):
    """With every input a constant, ``perf.chacha8_block_ops`` folds the
    whole block: its words are the plain version's and nothing is left to
    run (so the model follows ChaCha8's own dataflow)."""
    rng = np.random.default_rng(seed)
    key = rng.integers(0, 2**32, 2, dtype=np.uint64).astype(np.int64)
    ctr, nonce = int(rng.integers(0, 24)), int(rng.integers(0, 2**32))
    words, adds, alu = perf.chacha8_block_ops(int(key[0]), int(key[1]), ctr,
                                              nonce)
    want = ct.chacha8_blocks(torch.from_numpy(key[:, None]),
                             torch.tensor([ctr]), torch.tensor([nonce]))
    assert words == want[:, 0].tolist()
    assert (adds, alu) == (0, 0)


@pytest.mark.parametrize("key1", [0, 1])
def test_chacha_op_model_of_the_pool_kernels(key1):
    """The pool kernels' block (the seed's high word a literal, the low
    word, counter and nonce run-time): of the 400 operations written, the
    two column quarter rounds of constants in the first double round and
    the final additions of zero input words fold; XORs and rotations
    outnumber additions, so the ALU pipe bounds the block."""
    words, adds, alu = perf.chacha8_block_ops(key1=key1)
    assert all(w is None for w in words)
    assert adds + alu <= 400 - 2 * 12 - 8
    assert alu > adds
    assert perf.chacha_block_issue(key1) == alu


def test_units_from_words_matches_jax():
    """Every rounding edge: 0, 2^32 - 129 .. 2^32 - 1 (u rounds to exactly
    1.0 from 2^32 - 128 on), 2^24 +- 1, random words."""
    w = np.concatenate([[0, 1, 2**24 - 1, 2**24, 2**24 + 1],
                        np.arange(2**32 - 129, 2**32),
                        np.random.default_rng(4).integers(0, 2**32, 1000)])
    got = ct.units_from_words(torch.from_numpy(w.astype(np.int64)))
    want = np.asarray(cj.units_from_words(jnp.asarray(w.astype(np.uint32))))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    edge = got.numpy()[5:5 + 129]
    assert edge[0] < 1.0 and (edge[1:] == 1.0).all()


# ---- reference bits and channel values --------------------------------------

@pytest.mark.parametrize("start,n_vars", [(17, 500), (WRAP, 1031)])
def test_reference_bits_match_jax_and_host(start, n_vars):
    bits, packed = ct.reference_bits_packed(start, n_vars, 64, "cpu")
    want = np.asarray(cj.reference_bits_device(
        jnp.asarray(start, jnp.uint32), n_vars, 64))
    np.testing.assert_array_equal(bits.numpy(), want)
    np.testing.assert_array_equal(bits.numpy(),
                                  generate_reference_bits(n_vars, start, 64))
    jpacked = np.asarray(jdd._pack_rows(jnp.asarray(want), packed.shape[1]))
    np.testing.assert_array_equal(packed.numpy().view(np.uint32), jpacked)
    assert torch.equal(ct.reference_bits(start, n_vars, 64, "cpu"), bits)


def _jax_values(channel, ref, start, n_vars, n, noise):
    fn = {"bsc": cj.bsc_values_device, "erasure": cj.erasure_values_device,
          "awgn": cj.awgn_values_device}[channel]
    return np.asarray(fn(jnp.asarray(ref.numpy()), jnp.asarray(start,
                                                                jnp.uint32),
                         n_vars, n, noise))


@pytest.mark.parametrize("start", [9, WRAP])
@pytest.mark.parametrize("channel,noise,fn", [
    ("bsc", 0.07, ct.bsc_values), ("erasure", 0.3, ct.erasure_values)])
def test_bsc_and_erasure_values_match_jax(start, channel, noise, fn):
    n_vars, n = 777, 64
    ref = ct.reference_bits(start, n_vars, n, "cpu")
    got = fn(ref, start, n_vars, n, noise)
    want = _jax_values(channel, ref, start, n_vars, n, noise)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not np.signbit(want[want == 0]).any()  # +0.0 where erased


@pytest.mark.parametrize("start", [0, WRAP])
def test_awgn_values_match_jax(start):
    n_vars, n = 777, 64
    ref = ct.reference_bits(start, n_vars, n, "cpu")
    got = ct.awgn_values(ref, start, n_vars, n, 0.9).numpy()
    want = _jax_values("awgn", ref, start, n_vars, n, 0.9)
    np.testing.assert_allclose(got, want, rtol=0, atol=AWGN_ATOL)
    assert (np.sign(got) == np.sign(want)).mean() > 0.999


def test_awgn_statistics_and_determinism():
    """JAX's test_device_awgn_statistics_and_determinism on the port."""
    ref = torch.ones((4096, 32), dtype=torch.int8)
    a = ct.awgn_values(ref, 0, 4096, 32, 0.9)
    b = ct.awgn_values(ref, 0, 4096, 32, 0.9)
    assert torch.equal(a, b)
    noise = a - 1.0
    assert abs(float(noise.mean())) < 0.01
    assert abs(float(noise.std()) - 0.9) < 0.01
    assert not torch.equal(a, ct.awgn_values(ref, 1, 4096, 32, 0.9))


def test_entry_points_refuse_bad_arguments():
    ref = ct.reference_bits(0, 64, 32, "cpu")
    with pytest.raises(ValueError, match="multiple of 32"):
        ct.reference_bits(0, 64, 48, "cpu")
    with pytest.raises(ValueError, match="channel"):
        ct.channel_values(ref, 0, "gaussian", 0.5)
    with pytest.raises(ValueError, match="ref_bits"):
        ct.bsc_values(ref, 0, 65, 32, 0.1)
    with pytest.raises(ValueError, match="device"):
        ct.reference_bits(0, 64, 32, "meta")


# ---- pools: every kernel family --------------------------------------------

def _port_code(jcode):
    """The JAX code's graph as a port LDPCCode (the alist round trip)."""
    return LDPCCode.from_alist_data(AlistData(
        n_checks=jcode.n_checks, n_vars=jcode.n_vars,
        check_degrees=np.diff(jcode.out_bit_to_edge).astype(np.int32),
        var_degrees=np.diff(jcode.in_bit_to_edge).astype(np.int32),
        check_adjacency=jcode.in_edge_to_bit[jcode.edge_out_to_in],
        n_erased_vars=jcode.n_erased_vars))


def _interleaved():
    """A regular QC code renumbered block-interleaved on both sides (the
    decoders find it by the interleaved search)."""
    from ldpc_decoder_tpu.codes.alist import AlistData as JaxAlistData
    from ldpc_decoder_tpu.codes.code import LDPCCode as JaxLDPCCode

    jcode, js = jqc.make_qc_code(jax_regular_base(4, 8, 3, 6, seed=5),
                                 Z=256, seed=2, coarse=64, fine_mod=16,
                                 min_girth=0)
    Z = js.Z
    a_v, a_c = np.arange(jcode.n_vars), np.arange(jcode.n_checks)
    to_v = (a_v % Z) * (jcode.n_vars // Z) + a_v // Z
    to_c = (a_c % Z) * (jcode.n_checks // Z) + a_c // Z
    rows = np.repeat(a_c, np.diff(jcode.out_bit_to_edge))
    cols = jcode.in_edge_to_bit[jcode.edge_out_to_in].astype(np.int64)
    nr, nc = to_c[rows], to_v[cols]
    order = np.lexsort((nc, nr))
    return JaxLDPCCode.from_alist_data(JaxAlistData(
        n_checks=jcode.n_checks, n_vars=jcode.n_vars,
        check_degrees=np.bincount(nr, minlength=jcode.n_checks).astype(
            np.int32),
        var_degrees=np.bincount(nc, minlength=jcode.n_vars).astype(np.int32),
        check_adjacency=nc[order].astype(np.int32))), None


def _family(name):
    """(JAX code, JAX structure or None, port code, port structure or None,
    the port decoder's table type, extra StaticParams)."""
    if name == "grouped":
        jcode, js = jax_p41(Z=128, m=4, coarse=64, fine_mod=16)
    elif name == "regular":
        jcode, js = jqc.make_qc_code(np.ones((3, 6), np.int8), Z=128, seed=1)
    elif name == "general":
        jcode, js = jax_make_regular(512, 3, 6, seed=3), None
    else:
        jcode, js = _interleaved()
    s = None if js is None else structure_from_numpy(
        js.Z, js.n_base_rows, js.n_base_cols, js.edge_row, js.edge_col,
        js.edge_shift)
    code = _port_code(jcode) if s is None else qc_to_code(
        s, jcode.n_erased_vars)
    tables = {"grouped": GroupedQCTables, "regular": QCRegularTables,
              "general": GeneralTables, "interleaved": QCRegularTables}[name]
    kw = {"general": dict(qc_autodetect=False)}.get(name, {})
    return jcode, js, code, s, tables, kw


FAMILIES = ("grouped", "regular", "general", "interleaved")
CHANNELS = {"bsc": (BSCChannel(0.05), JaxBSC(0.05)),
            "erasure": (ErasureChannel(0.3), JaxErasure(0.3)),
            "awgn": (BIAWGNChannel(0.8), JaxAwgn(0.8))}


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    name = request.param
    jcode, js, code, s, tables, kw = _family(name)
    dec = {ch: LDPCDecoder(code, pch, StaticParams(parallel_factor_user=32,
                                                   **kw),
                           qc=s, device="cpu")
           for ch, (pch, _) in CHANNELS.items()}
    jdec = {ch: JaxLDPCDecoder(jcode, jch, jparams.StaticParams(
        parallel_factor_user=32, **kw), qc=js)
        for ch, (_, jch) in CHANNELS.items()}
    assert all(isinstance(d.tables, tables) for d in dec.values())
    if name == "interleaved":
        d = dec["bsc"]
        Z = d.qc.Z  # the retire's rows are not whole Z-blocks in order
        rows = d._src_row.numpy().reshape(-1, Z)
        assert not (rows == rows[:, :1] + np.arange(Z)).all()
    return dict(name=name, code=code, dec=dec, jdec=jdec)


def _natural(sorted_rows, order):
    """Rows in the natural order of an I/O order (sorted row i holds
    natural row order[i])."""
    out = np.empty_like(sorted_rows)
    out[np.asarray(order)] = sorted_rows
    return out


@pytest.mark.parametrize("channel", sorted(CHANNELS))
def test_pool_matches_jax(family, channel):
    """The pool against JAX's create_pool_device, in natural order through
    each side's own order maps; the erased tail is 0.0."""
    code, dec, jdec = family["code"], family["dec"][channel], \
        family["jdec"][channel]
    start, n = 11, 64
    pool = dd.create_pool_device(dec, CHANNELS[channel][0], start, n)
    jpool = jdd.create_pool_device(jdec.cc, jdec.tables,
                                   CHANNELS[channel][1], start, n)
    nv, nc = code.n_vars, code.n_checks
    jv, jc = jdec._vn_order_io, jdec._cn_order_io
    vals = _natural(pool.values_sorted.numpy(), dec._vn_order_io)
    jvals = _natural(np.asarray(jpool.values_sorted)[:nv], jv)
    np.testing.assert_array_equal(
        _natural(pool.syn_sorted.numpy(), dec._cn_order_io),
        _natural(np.asarray(jpool.syn_sorted)[:nc], jc))
    np.testing.assert_array_equal(pool.ref_packed.numpy().view(np.uint32),
                                  np.asarray(jpool.ref_packed))
    if channel == "awgn":
        np.testing.assert_allclose(vals, jvals, rtol=0, atol=AWGN_ATOL)
    else:
        np.testing.assert_array_equal(vals, jvals)
    if code.n_erased_vars:
        assert (vals[nv - code.n_erased_vars:] == 0.0).all()
        assert (vals[:nv - code.n_erased_vars] != 0.0).any()


@pytest.mark.parametrize("channel", ["bsc", "erasure"])
def test_pool_matches_host_upload(family, channel):
    """BSC and erasure: the pool is the host datagen's batch as
    upload_pools lays it out, every array exact."""
    code, dec = family["code"], family["dec"][channel]
    ch = CHANNELS[channel][0]
    pool = dd.create_pool_device(dec, ch, 3, 64)
    batch = create_data(code, ch, 3, 64, backend="numpy")
    pv, ps = dec.upload_pools(batch.values, batch.syndromes)
    assert torch.equal(pool.values_sorted, pv)
    assert torch.equal(pool.syn_sorted, ps)
    np.testing.assert_array_equal(pool.ref_packed.numpy().view(np.uint32),
                                  batch.ref_bits_packed())


def test_awgn_pool_matches_host_bits(family):
    """BI-AWGN: the host draws the polar method, the pool Box-Muller; the
    bits, syndromes and packed words are the same."""
    code, dec = family["code"], family["dec"]["awgn"]
    ch = CHANNELS["awgn"][0]
    pool = dd.create_pool_device(dec, ch, 0, 64)
    batch = create_data(code, ch, 0, 64, backend="numpy")
    _, ps = dec.upload_pools(batch.values, batch.syndromes)
    assert torch.equal(pool.syn_sorted, ps)
    np.testing.assert_array_equal(pool.ref_packed.numpy().view(np.uint32),
                                  batch.ref_bits_packed())


@pytest.mark.parametrize("channel", sorted(CHANNELS))
def test_pool_chunks_do_not_change_it(family, channel):
    """Chunks of 32, 64 and all 96 frames, and batch_index, give the same
    pool: every seed is an absolute frame index."""
    dec = family["dec"][channel]
    ch = CHANNELS[channel][0]
    pools = [dd.create_pool_device(dec, ch, 5, 96, chunk_frames=c)
             for c in (32, 64, 96)]
    pools.append(dd.create_pool_device(dec, ch, -91, 96, batch_index=1))
    for p in pools[1:]:
        for a, b in zip(pools[0], p):
            assert torch.equal(a, b)


def test_syndrome_sorted_matches_jax_family_functions(family):
    """One plain syndrome for every family against JAX's per-family ones
    (syndrome_from_bits_qc_grouped, _qc_pallas, syndrome_from_bits) on
    random bits."""
    code, dec, jdec = family["code"], family["dec"]["bsc"], \
        family["jdec"]["bsc"]
    bits = (np.random.default_rng(6).random((code.n_vars, 40)) < 0.5).astype(
        np.int8)
    t = dd._pool_tables(dec)
    syn = dd.syndrome_sorted(torch.from_numpy(bits), t.edge_var,
                             t.edge_check, t.cn_order, code.n_checks)
    jbits = jnp.asarray(bits[np.asarray(jdec.tables.vn_order)])
    from ldpc_decoder_tpu.ops.decode import syndrome_from_bits
    from ldpc_decoder_tpu.ops.qc_pallas import (
        QCPallasTables,
        syndrome_from_bits_qc_pallas,
    )
    from ldpc_decoder_tpu.ops.qc_pallas_grouped import (
        GroupedQCPallasTables,
        syndrome_from_bits_qc_grouped,
    )

    if isinstance(jdec.tables, GroupedQCPallasTables):
        jsyn = syndrome_from_bits_qc_grouped(jbits, jdec.tables)
    elif isinstance(jdec.tables, QCPallasTables):
        jsyn = syndrome_from_bits_qc_pallas(jbits, jdec.tables)
    else:
        jsyn = syndrome_from_bits(jbits, jdec.tables)
    np.testing.assert_array_equal(
        _natural(syn.numpy(), dec._cn_order_io),
        _natural(np.asarray(jsyn)[:code.n_checks], jdec._cn_order_io))


def test_pool_zeroes_a_set_erased_tail(family):
    """set_erased_variables moves the zeroed tail of later pools."""
    code, dec = family["code"], LDPCDecoder(
        family["code"], BSCChannel(0.05), StaticParams(
            parallel_factor_user=32, qc_autodetect=family["name"] != "general"),
        device="cpu")
    dec.set_erased_variables(code.n_erased_vars + 32)
    ch = BSCChannel(0.05)
    pool = dd.create_pool_device(dec, ch, 0, 32)
    batch = create_data(dec.code, ch, 0, 32, backend="numpy")
    pv, ps = dec.upload_pools(batch.values, batch.syndromes)
    assert torch.equal(pool.values_sorted, pv)
    vals = _natural(pool.values_sorted.numpy(), dec._vn_order_io)
    assert (vals[code.n_vars - dec.code.n_erased_vars:] == 0.0).all()


def test_create_pool_refuses_bad_arguments():
    code = _port_code(jax_make_regular(512, 3, 6, seed=3))
    dec = LDPCDecoder(code, BSCChannel(0.05), StaticParams(
        parallel_factor_user=32, qc_autodetect=False), device="cpu")
    with pytest.raises(ValueError, match="% 32"):
        dd.create_pool_device(dec, BSCChannel(0.05), 0, 48)

    class Other:
        channel_type = "rayleigh"

    with pytest.raises(ValueError, match="unsupported channel"):
        dd.create_pool_device(dec, Other(), 0, 32)


# ---- the error count and the whole pipeline ------------------------------------

def test_count_bit_errors_matches_jax():
    """Random words with bit 31 set in many of them, and JAX's own case."""
    rng = np.random.default_rng(8)
    a = rng.integers(0, 2**32, (37, 11), dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 2**32, (37, 11), dtype=np.uint64).astype(np.uint32)
    b[::3] |= np.uint32(1 << 31)
    got = dd.count_bit_errors(torch.from_numpy(a.view(np.int32)),
                              torch.from_numpy(b.view(np.int32)))
    want = np.asarray(jdd.count_bit_errors(jnp.asarray(a), jnp.asarray(b)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    ref = np.array([[0b1011, 0], [0, 0]], np.uint32).view(np.int32)
    res = np.array([[0b1000, 0], [0, 1 << 31]], np.uint32).view(np.int32)
    assert dd.count_bit_errors(torch.from_numpy(res),
                               torch.from_numpy(ref)).tolist() == [2, 1]


@pytest.mark.parametrize("channel", ["awgn", "bsc"])
def test_pipeline_decodes_like_jax(channel):
    """JAX's test_full_device_pipeline_decodes on the port: generate,
    decode_presorted(fetch_results=False), count; no error. Against the
    JAX pipeline on the same frames (its general path in float32): the
    same words, and over the BSC, whose values are exact, the same
    per-frame iterations."""
    jcode = jax_make_regular(1024, 3, 6, seed=4)
    noise = {"awgn": 0.65, "bsc": 0.02}[channel]
    pch = {"awgn": BIAWGNChannel, "bsc": BSCChannel}[channel](noise)
    jch = {"awgn": JaxAwgn, "bsc": JaxBSC}[channel](noise)
    dec = LDPCDecoder(_port_code(jcode), pch, StaticParams(
        max_log_parallel_factor_user=4, device_memory_bytes=1 << 30),
        device="cpu")
    jdec = JaxLDPCDecoder(jcode, jch, jparams.StaticParams(
        max_log_parallel_factor_user=4))
    assert dec.parallel_factor() == jdec.parallel_factor() == 16
    n = 32
    pool = dd.create_pool_device(dec, pch, 0, n)
    results, stats = dec.decode_presorted(
        DynamicParams(num_iter_max=50, num_iter_check_parity=5,
                      loading_factor=2), n, pool.values_sorted,
        pool.syn_sorted, fetch_results=False)
    assert results.dtype == torch.int32
    errors = dd.count_bit_errors(results, pool.ref_packed)
    assert int(errors.sum()) == 0
    jpool = jdd.create_pool_device(jdec.cc, jdec.tables, jch, 0, n)
    jres, jst = jdec.decode_presorted(
        jparams.DynamicParams(num_iter_max=50, num_iter_check_parity=5,
                              loading_factor=2), n, jpool.values_sorted,
        jpool.syn_sorted, fetch_results=False)
    np.testing.assert_array_equal(results.numpy().view(np.uint32),
                                  np.asarray(jres))
    if channel == "bsc":
        np.testing.assert_array_equal(stats.iterations, jst.iterations)
