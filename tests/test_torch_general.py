"""The port's general (any-alist) path against the JAX package's.

The JAX passes (``ops/general_pallas.py``) run as the JAX package's own
tests run them on the CPU (Pallas interpret mode); the port's passes take
their plain PyTorch versions on CPU tensors. Both get the same state, made
from a seed with numpy and carried across by
``ldpc_decoder_tpu_torch.convert`` (the JAX layout pads each bucket to
its kernel tile, the port's does not). Two small codes: a random (3,6)
code (one bucket per side) and a multi-bucket irregular code with
degree-1 variables and degree-1 checks.

Tolerances: sum-product messages within PHI_RTOL (the XLA-vs-torch φ
difference, tests/test_torch_phi_channels.py; both sides sum in the same
order, so φ is the only difference); min-sum messages, sign bits, hard
bits, parity flags, decoded words and iteration counts exact.

The CUDA kernels are held to these plain versions on the card by
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from ldpc_decoder_tpu.channels import BIAWGNChannel as JaxBIAWGN  # noqa: E402
from ldpc_decoder_tpu.codes.compiled import compile_code as jcompile  # noqa: E402
from ldpc_decoder_tpu.codes.generate import (  # noqa: E402
    make_irregular_code as jmake_irregular,
    make_regular_code as jmake_regular,
)
from ldpc_decoder_tpu.ops import general_pallas as GP  # noqa: E402
from ldpc_decoder_tpu.runtime import params as jparams  # noqa: E402
from ldpc_decoder_tpu.runtime.datagen import create_data  # noqa: E402
from ldpc_decoder_tpu.runtime.decoder import (  # noqa: E402
    LDPCDecoder as JaxLDPCDecoder,
)

from ldpc_decoder_tpu_torch.channels import BIAWGNChannel  # noqa: E402
from ldpc_decoder_tpu_torch.codes.compiled import compile_code  # noqa: E402
from ldpc_decoder_tpu_torch.codes.generate import (  # noqa: E402
    make_irregular_code,
    make_regular_code,
)
from ldpc_decoder_tpu_torch.convert import (  # noqa: E402
    general_rows,
    general_state_from_jax,
    general_state_to_jax,
)
from ldpc_decoder_tpu_torch.ops import general as G  # noqa: E402
from ldpc_decoder_tpu_torch.runtime.decoder import LDPCDecoder  # noqa: E402
from ldpc_decoder_tpu_torch.runtime.params import (  # noqa: E402
    DynamicParams,
    StaticParams,
)

PHI_RTOL = 5e-5
B = 8
# (constructor, args): the same seed gives the same code in both packages
CODES = {
    "regular": ("regular", (256, 3, 6), dict(seed=7)),
    # 20/60/80/40 variables of degree 1/2/3/4 and 10/10/80 checks of
    # degree 1/5/6: 540 edges on each side, so no degree is nudged
    "irregular": ("irregular", (200, 100, {1: 0.1, 2: 0.3, 3: 0.4, 4: 0.2},
                                {1: 0.1, 5: 0.1, 6: 0.8}), dict(seed=5)),
}
ALPHA_TABLE = ((1, 0.5), (5, 0.9), (0, 0.75))
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16),
          "int8": (torch.int8, jnp.int8)}


def _make(name):
    kind, args, kw = CODES[name]
    if kind == "regular":
        return jmake_regular(*args, **kw), make_regular_code(*args, **kw)
    return jmake_irregular(*args, **kw), make_irregular_code(*args, **kw)


@pytest.fixture(scope="module", params=sorted(CODES))
def code(request):
    jcode, pcode = _make(request.param)
    tp = GP.GeneralPallasTables.from_compiled(jcompile(jcode))
    t = G.GeneralTables.from_compiled(compile_code(pcode), "cpu")
    return dict(name=request.param, jcode=jcode, pcode=pcode, tp=tp, t=t)


@pytest.fixture(scope="module")
def irregular():
    jcode, pcode = _make("irregular")
    tp = GP.GeneralPallasTables.from_compiled(jcompile(jcode))
    t = G.GeneralTables.from_compiled(compile_code(pcode), "cpu")
    return dict(name="irregular", jcode=jcode, pcode=pcode, tp=tp, t=t)


# ---- carrying state across ---------------------------------------------------

def _edges_to_jax(c, x, side):
    tp = c["tp"]
    jb, pb, n = ((tp.vn_buckets, c["t"].vn_buckets, tp.ev_pad) if side == "v"
                 else (tp.cn_buckets, c["t"].cn_buckets, tp.ec_pad))
    return general_state_to_jax(np.asarray(x), jb, pb, n)


def _edges_from_jax(c, x, side):
    tp = c["tp"]
    jb, pb = ((tp.vn_buckets, c["t"].vn_buckets) if side == "v"
              else (tp.cn_buckets, c["t"].cn_buckets))
    return general_state_from_jax(np.asarray(x), jb, pb)


def _nodes_to_jax(c, x, side):
    tp = c["tp"]
    jb, pb, n = ((tp.vn_buckets, c["t"].vn_buckets, tp.nv_pad) if side == "v"
                 else (tp.cn_buckets, c["t"].cn_buckets, tp.nc_pad))
    return general_state_to_jax(np.asarray(x), jb, pb, n, edges=False)


def _nodes_from_jax(c, x, side):
    tp = c["tp"]
    jb, pb = ((tp.vn_buckets, c["t"].vn_buckets) if side == "v"
              else (tp.cn_buckets, c["t"].cn_buckets))
    return general_state_from_jax(np.asarray(x), jb, pb, edges=False)


def _random_state(t, seed, scale=4.0):
    rng = np.random.default_rng(seed)
    return dict(
        msgs_v=(rng.standard_normal((t.n_edges, B)) * scale).astype(
            np.float32),
        r_c=(rng.standard_normal((t.n_edges, B)) * scale).astype(np.float32),
        llr=(rng.standard_normal((t.n_vars, B)) * 3).astype(np.float32),
        syn=(rng.random((t.n_checks, B)) < 0.5).astype(np.int8),
    )


def _as(x, dtype_name):
    """float32 numpy -> (torch, jax) arrays of one message dtype (int8:
    integer steps in [-40, 40], about ±10 LLR at qscale 4)."""
    tdt, jdt = DTYPES[dtype_name]
    if dtype_name == "int8":
        q = np.clip(np.round(x * 2.5), -40, 40).astype(np.int8)
        return torch.from_numpy(q), q
    t = torch.from_numpy(x).to(tdt)
    return t, np.asarray(jnp.asarray(x).astype(jdt))


def _assert_msgs_close(port, ref):
    port = np.asarray(port, np.float32)
    ref = np.asarray(ref, np.float32)
    np.testing.assert_array_equal(np.signbit(port), np.signbit(ref))
    np.testing.assert_allclose(port, ref, rtol=PHI_RTOL, atol=0)


def _bitwise(port, ref):
    port = port.contiguous()
    as_int = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
              torch.int8: torch.int8}[port.dtype]
    ref_t = torch.from_numpy(np.asarray(ref).astype(np.float32)).to(
        port.dtype) if port.dtype != torch.int8 else torch.from_numpy(
        np.asarray(ref))
    assert torch.equal(port.view(as_int), ref_t.view(as_int))


# ---- tables ------------------------------------------------------------------

def test_tables_match_jax(code):
    """The port's unpadded tables are the JAX padded ones, row for row."""
    tp, t = code["tp"], code["t"]
    vrow = general_rows(tp.vn_buckets, t.vn_buckets)
    crow = general_rows(tp.cn_buckets, t.cn_buckets)
    vnode = general_rows(tp.vn_buckets, t.vn_buckets, edges=False)
    np.testing.assert_array_equal(np.asarray(tp.perm_v2c)[crow],
                                  vrow[t.perm_v2c.numpy()])
    np.testing.assert_array_equal(np.asarray(tp.perm_c2v)[vrow],
                                  crow[t.perm_c2v.numpy()])
    np.testing.assert_array_equal(np.asarray(tp.cn_edge_vnrow)[crow],
                                  vnode[t.cn_edge_vnrow.numpy()])
    np.testing.assert_array_equal(np.asarray(tp.vn_pos),
                                  vnode[t.vn_pos.numpy()])
    np.testing.assert_array_equal(np.asarray(tp.vn_order)[vnode],
                                  t.vn_order.numpy())
    np.testing.assert_array_equal(
        np.asarray(tp.erased_mask_sorted)[vnode], t.erased_mask_sorted.numpy())


def test_permutations_invert(code):
    t = code["t"]
    v2c, c2v = t.perm_v2c.long(), t.perm_c2v.long()
    idx = torch.arange(t.n_edges)
    assert torch.equal(v2c[c2v], idx)
    assert torch.equal(c2v[v2c], idx)
    degs = {b.degree for b in t.vn_buckets} | {b.degree for b in t.cn_buckets}
    if code["name"] == "irregular":
        assert 1 in {b.degree for b in t.vn_buckets}
        assert 1 in {b.degree for b in t.cn_buckets}
        assert len(degs) >= 5


def test_state_conversion_round_trip(code):
    t = code["t"]
    st = _random_state(t, 1)
    for side in ("v", "c"):
        back = _edges_from_jax(code, _edges_to_jax(code, st["msgs_v"], side),
                               side)
        np.testing.assert_array_equal(back, st["msgs_v"])
    back = _nodes_from_jax(code, _nodes_to_jax(code, st["llr"], "v"), "v")
    np.testing.assert_array_equal(back, st["llr"])


# ---- init --------------------------------------------------------------------

@pytest.mark.parametrize("alg,dtype", [
    ("sum-product", "float32"), ("sum-product", "bfloat16"),
    ("min-sum", "bfloat16"), ("min-sum", "int8")])
def test_init_messages_matches_jax(code, alg, dtype):
    t = code["t"]
    llr = _random_state(t, 2)["llr"] * 10  # past the int8 clamp too
    tdt, jdt = DTYPES[dtype]
    llr_t = torch.from_numpy(llr).to(G.llr_dtype(tdt))
    llr_j = jnp.asarray(_nodes_to_jax(code, llr_t.float().numpy(), "v"))
    if llr_t.dtype == torch.bfloat16:
        llr_j = llr_j.astype(jnp.bfloat16)
    ref = GP.init_messages_general(llr_j, code["tp"], dtype=jdt, alg=alg,
                                   clamp=30.0, qscale=4.0)
    mv, rc = G.init_messages_general(llr_t, t, tdt, alg=alg, clamp=30.0,
                                     qscale=4.0)
    assert rc.shape == mv.shape == (t.n_edges, B)
    ref = _edges_from_jax(code, ref, "v")
    if alg == "min-sum":
        _bitwise(mv, ref)
    else:
        _assert_msgs_close(mv.float().numpy(), np.asarray(ref, np.float32))


# ---- sum-product passes ------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cn_pass_matches_jax(code, dtype):
    t = code["t"]
    st = _random_state(t, 3)
    mv, mv_j = _as(st["msgs_v"], dtype)
    m_c = _edges_to_jax(code, mv_j[t.perm_v2c.numpy()], "c")
    syn_j = _nodes_to_jax(code, st["syn"], "c")
    ref = GP.cn_update_general(jnp.asarray(m_c), jnp.asarray(syn_j),
                               code["tp"])
    r_c = torch.empty_like(mv)
    out = G.cn_pass_general(mv, torch.from_numpy(st["syn"]), r_c, t)
    assert out is r_c  # written in place
    _assert_msgs_close(out.float().numpy(),
                       np.asarray(_edges_from_jax(code, ref, "c"), np.float32))


@pytest.mark.parametrize("emit", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vn_pass_matches_jax(code, dtype, emit):
    t = code["t"]
    st = _random_state(t, 4)
    rc, rc_j = _as(st["r_c"], dtype)
    llr, llr_j = _as(st["llr"], dtype)
    r_v = _edges_to_jax(code, rc_j[t.perm_c2v.numpy()], "v")
    ref, bits_j = GP.vn_update_general(
        jnp.asarray(r_v), jnp.asarray(_nodes_to_jax(code, llr_j, "v")),
        code["tp"])
    msgs_v = torch.empty_like(rc)
    bits = torch.full((t.n_vars, B), -1, dtype=torch.int8) if emit else None
    out = G.vn_pass_general(rc, llr, msgs_v, t, bits=bits)
    assert out is msgs_v
    _assert_msgs_close(out.float().numpy(),
                       np.asarray(_edges_from_jax(code, ref, "v"), np.float32))
    if emit:
        np.testing.assert_array_equal(bits.numpy(),
                                      _nodes_from_jax(code, bits_j, "v"))


# ---- min-sum passes (bitwise) --------------------------------------------------

@pytest.mark.parametrize("alpha,beta", [
    (0.8, 0.0), (ALPHA_TABLE, 0.0), (ALPHA_TABLE, 0.25)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_minsum_cn_pass_bitwise(code, dtype, alpha, beta):
    """Bitwise, with one exception: XLA:CPU contracts α·m − β into one
    fused multiply-add (one rounding), where the port (plain version and
    kernel alike) rounds the product and the difference separately, as
    the expression is written. With β ≠ 0 the float32 messages may then
    differ by up to 2 ulps of α·|m|; bf16 and int8 storage round that
    away on these inputs, and with β = 0 both agree bit for bit."""
    t = code["t"]
    st = _random_state(t, 5)
    mv, mv_j = _as(st["msgs_v"], dtype)
    m_c = _edges_to_jax(code, mv_j[t.perm_v2c.numpy()], "c")
    ref = GP.cn_update_general(
        jnp.asarray(m_c), jnp.asarray(_nodes_to_jax(code, st["syn"], "c")),
        code["tp"], alg="min-sum", beta=beta, alpha=alpha, qscale=4.0)
    out = G.cn_pass_general_minsum(mv, torch.from_numpy(st["syn"]),
                                   torch.empty_like(mv), t, alpha, beta, 4.0)
    ref = _edges_from_jax(code, ref, "c")
    if dtype == "float32" and beta:
        port, ref = out.numpy(), np.asarray(ref)
        np.testing.assert_array_equal(np.signbit(port), np.signbit(ref))
        tol = 2 * np.spacing(np.abs(ref) + np.float32(beta))
        assert (np.abs(port - ref) <= tol).all()
        assert (port != ref).any()  # the contraction shows on these inputs
    else:
        _bitwise(out, ref)


@pytest.mark.parametrize("emit", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_minsum_vn_pass_bitwise(code, dtype, emit):
    t = code["t"]
    st = _random_state(t, 6)
    rc, rc_j = _as(st["r_c"], dtype)
    ldt = "bfloat16" if dtype == "int8" else dtype
    llr, llr_j = _as(st["llr"] * 4, ldt)  # some past the clamp
    r_v = _edges_to_jax(code, rc_j[t.perm_c2v.numpy()], "v")
    ref, bits_j = GP.vn_update_general(
        jnp.asarray(r_v), jnp.asarray(_nodes_to_jax(code, llr_j, "v")),
        code["tp"], msg_dtype=DTYPES[dtype][1], alg="min-sum", clamp=20.0,
        qscale=4.0)
    bits = torch.full((t.n_vars, B), -1, dtype=torch.int8) if emit else None
    out = G.vn_pass_general_minsum(rc, llr, torch.empty_like(rc), t, 20.0,
                                   4.0, bits=bits)
    _bitwise(out, _edges_from_jax(code, ref, "v"))
    if emit:
        np.testing.assert_array_equal(bits.numpy(),
                                      _nodes_from_jax(code, bits_j, "v"))


# ---- parity and whole supersteps ------------------------------------------------

def test_parity_matches_jax(code):
    t = code["t"]
    rng = np.random.default_rng(7)
    bits = (rng.random((t.n_vars, B)) < 0.5).astype(np.int8)
    # syndromes of these bits, then three lanes with one check flipped
    x = bits[t.cn_edge_vnrow.numpy()].astype(np.int64)
    syn = np.zeros((t.n_checks, B), np.int8)
    for b in t.cn_buckets:
        rows = x[b.edge_start:b.edge_start + b.degree * b.count].reshape(
            b.degree, b.count, B)
        syn[b.row_start:b.row_start + b.count] = rows.sum(0) & 1
    bad = [1, 4, 6]
    syn[t.n_checks - 1, bad] ^= 1
    ref = GP.parity_violations_general(
        jnp.asarray(_nodes_to_jax(code, bits, "v")),
        jnp.asarray(_nodes_to_jax(code, syn, "c")), code["tp"])
    out = G.parity_violations_general(torch.from_numpy(bits),
                                      torch.from_numpy(syn), t)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(np.nonzero(out.numpy())[0], bad)


def _frames(c, sigma, seed):
    """Sorted llr [n_vars, B] (float32) and syndromes of B real frames."""
    batch = create_data(c["jcode"], JaxBIAWGN(sigma), seed, B,
                        backend="numpy")
    t = c["t"]
    llr = JaxBIAWGN(sigma).llr_np(batch.values)[t.vn_order.numpy()]
    syn = batch.syndromes[t.cn_order.numpy()].astype(np.int8)
    return np.ascontiguousarray(llr, np.float32), np.ascontiguousarray(syn)


ALGS = {
    "sum-product": dict(alg="sum-product"),
    "min-sum-int8": dict(alg="min-sum", beta=0.0, alpha=ALPHA_TABLE,
                         clamp=24.0, qscale=4.0),
}


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("alg", sorted(ALGS))
def test_run_iterations_matches_jax(code, alg, k):
    """Two supersteps of k iterations on real frames from the same init:
    hard bits and flags exact; int8 min-sum messages bitwise."""
    kw = ALGS[alg]
    dtype = "int8" if alg == "min-sum-int8" else "float32"
    tdt, jdt = DTYPES[dtype]
    llr, syn = _frames(code, 0.8, 3)
    llr_t = torch.from_numpy(llr).to(G.llr_dtype(tdt))
    llr_j = jnp.asarray(_nodes_to_jax(code, llr_t.float().numpy(), "v"))
    if dtype == "int8":
        llr_j = llr_j.astype(jnp.bfloat16)
    syn_j = jnp.asarray(_nodes_to_jax(code, syn, "c"))
    init_kw = {a: kw[a] for a in ("alg", "clamp", "qscale") if a in kw}
    mj = GP.init_messages_general(llr_j, code["tp"], dtype=jdt, **init_kw)
    msgs = G.init_messages_general(llr_t, code["t"], tdt, **init_kw)
    for _ in range(2):
        mj, bits_j, viol_j = GP.run_iterations_general(
            mj, llr_j, syn_j, code["tp"], k, **kw)
        msgs, bits, viol = G.run_iterations_general(
            msgs, llr_t, torch.from_numpy(syn), code["t"], k, **kw)
        np.testing.assert_array_equal(bits.numpy(),
                                      _nodes_from_jax(code, bits_j, "v"))
        np.testing.assert_array_equal(viol.numpy(), np.asarray(viol_j))
    if dtype == "int8":
        _bitwise(msgs[0], _edges_from_jax(code, mj, "v"))


@pytest.mark.parametrize("alg", sorted(ALGS))
def test_burst_prefix_identity(irregular, alg):
    """burst(b) then run(k) equals run(b + k) bit for bit."""
    kw = ALGS[alg]
    tdt = torch.int8 if alg == "min-sum-int8" else torch.bfloat16
    t = irregular["t"]
    llr, syn = _frames(irregular, 0.8, 4)
    llr = torch.from_numpy(llr).to(G.llr_dtype(tdt))
    syn = torch.from_numpy(syn)
    init_kw = {a: kw[a] for a in ("alg", "clamp", "qscale") if a in kw}
    m0 = G.init_messages_general(llr, t, tdt, **init_kw)
    m1 = G.burst_iterations_general(tuple(x.clone() for x in m0), llr, syn,
                                    t, 3, **kw)
    m1, bits1, viol1 = G.run_iterations_general(m1, llr, syn, t, 2, **kw)
    m2, bits2, viol2 = G.run_iterations_general(
        tuple(x.clone() for x in m0), llr, syn, t, 5, **kw)
    as_int = torch.int16 if tdt == torch.bfloat16 else torch.int8
    assert torch.equal(m1[0].view(as_int), m2[0].view(as_int))
    assert torch.equal(bits1, bits2)
    assert torch.equal(viol1, viol2)


# ---- the decoder end to end ----------------------------------------------------

N = 3 * B + 5  # refills and a partial last fill
DEC_SIGMA = 0.72
DECODES = {
    "sum-product-f32": dict(message_dtype="float32"),
    "min-sum-int8": dict(message_dtype="int8", algorithm="min-sum",
                         minsum_alpha=0.8, minsum_offset=0.0),
    "sum-product-bf16": dict(message_dtype="bfloat16"),
}


@pytest.fixture(scope="module")
def decode_code():
    jcode = jmake_regular(512, 3, 6, seed=21)
    batch = create_data(jcode, JaxBIAWGN(DEC_SIGMA), 0, N, backend="numpy")
    return dict(jcode=jcode, pcode=make_regular_code(512, 3, 6, seed=21),
                batch=batch)


def _decode_both(dc, cfg):
    kw = DECODES[cfg]
    dyn = dict(num_iter_max=60, num_iter_check_parity=5)
    batch = dc["batch"]
    jdec = JaxLDPCDecoder(dc["jcode"], JaxBIAWGN(DEC_SIGMA),
                          jparams.StaticParams(parallel_factor_user=B,
                                               kernel_impl="pallas",
                                               qc_autodetect=False, **kw))
    jres, jst = jdec.decode(jparams.DynamicParams(**dyn), N, batch.values,
                            batch.syndromes)
    dec = LDPCDecoder(dc["pcode"], BIAWGNChannel(DEC_SIGMA),
                      StaticParams(parallel_factor_user=B,
                                   qc_autodetect=False, **kw), device="cpu")
    assert isinstance(dec.tables, G.GeneralTables)
    res, st = dec.decode(DynamicParams(**dyn), N, batch.values,
                         batch.syndromes)
    return (res, st), (np.asarray(jres), jst)


def _bit_errors(dc, res):
    return np.bitwise_count(dc["batch"].ref_bits_packed() ^ res).sum()


@pytest.mark.parametrize("cfg", ["sum-product-f32", "min-sum-int8"])
def test_decode_matches_jax(decode_code, cfg):
    """Equal words and per-frame iterations against the JAX decoder's
    Pallas general path (the non-lane-reset refill)."""
    (res, st), (jres, jst) = _decode_both(decode_code, cfg)
    assert res.dtype == np.uint32 and res.shape == jres.shape
    np.testing.assert_array_equal(res, jres)
    np.testing.assert_array_equal(st.iterations, jst.iterations)
    assert st.total_iterations == jst.total_iterations
    assert _bit_errors(decode_code, res) == 0


def test_decode_bfloat16_decodes_all(decode_code):
    (res, st), (jres, jst) = _decode_both(decode_code, "sum-product-bf16")
    assert _bit_errors(decode_code, res) == 0
    assert _bit_errors(decode_code, jres) == 0
    assert abs(st.avg_iter - jst.avg_iter) <= 5


def test_decode_accepts_compiled_code(decode_code):
    cc = compile_code(decode_code["pcode"])
    dec = LDPCDecoder(cc, BIAWGNChannel(DEC_SIGMA),
                      StaticParams(parallel_factor_user=B,
                                   qc_autodetect=False), device="cpu")
    assert dec.code is cc.code and dec.tables.n_edges == cc.n_edges


def test_lane_count_general(decode_code):
    """The lane model's general branch: two edge arrays, the parity
    gather's byte per edge and the node state per lane."""
    code = decode_code["pcode"]
    ch = BIAWGNChannel(DEC_SIGMA)
    with pytest.raises(ValueError, match="device_memory_bytes"):
        LDPCDecoder(code, ch, StaticParams(qc_autodetect=False), device="cpu")
    sp = dict(qc_autodetect=False, max_log_parallel_factor_user=12)
    e, nv, nc = code.n_edges, code.n_vars, code.n_checks
    per_lane = 2 * e * 2 + e + 3 * nv * 4 + nc
    per_frame = nv * 4 + nc + nv // 8
    table = 3 * e * 4 + 2 * nv * 4 + 2 * nc * 4
    mem = int((per_lane + 4 * per_frame) * 120 / 0.9) + table + 1000
    dec = LDPCDecoder(code, ch, StaticParams(
        message_dtype="bfloat16", device_memory_bytes=mem, **sp),
        device="cpu")
    assert dec.parallel_factor() == 64  # 119 lanes fit
    dec = LDPCDecoder(code, ch, StaticParams(
        message_dtype="int8", algorithm="min-sum", device_memory_bytes=mem,
        **sp), device="cpu")
    assert dec.parallel_factor() == 128  # 1-byte messages fit more


def test_passes_reject_other_devices(irregular):
    t = irregular["t"]
    m = torch.empty((t.n_edges, B), device="meta")
    syn = torch.empty((t.n_checks, B), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="device"):
        G.cn_pass_general(m, syn, torch.empty_like(m), t)
    with pytest.raises(ValueError, match="shape"):
        G.cn_pass_general(torch.zeros((t.n_edges, B)),
                          torch.zeros((t.n_checks, B + 1), dtype=torch.int8),
                          torch.zeros((t.n_edges, B)), t)
    with pytest.raises(ValueError, match="dtype"):
        G.cn_pass_general(torch.zeros((t.n_edges, B), dtype=torch.int8),
                          torch.zeros((t.n_checks, B), dtype=torch.int8),
                          torch.zeros((t.n_edges, B), dtype=torch.int8), t)
