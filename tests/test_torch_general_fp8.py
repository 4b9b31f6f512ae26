"""float8_e5m2 messages on the port's general (any-alist) path against the
JAX package's.

The JAX package sends float8_e5m2 on a code without QC structure to its XLA
bucket ops (``ldpc_decoder_tpu/ops/decode.py``), which keep the state in
check-edge order (``msgs_c``, node-major buckets); the port keeps msgs_v in
variable order, plane-major. The same seeded states go through both, mapped
onto each other by the port's edge layout (``ops/general.py`` ``_edge_map``)
and ``perm_v2c``. The code is a small irregular one with variable degrees
1-12 and check degrees 1 and 4-12.

Tolerances: signs, hard bits and parity flags exact everywhere. Min-sum
messages bit for bit (α = 1 or β = 0: XLA:CPU contracts α·m − β into one
FMA otherwise, ROADMAP Queue 3). Sum-product messages bit for bit except
where XLA's φ (within 1.74e-5 relative of torch's) puts a value on the
other side of a float8_e5m2 rounding edge: at most one step apart, on at
most FP8_EDGE_SHARE of the values. The decoder end to end: equal words and
per-frame iterations, sum-product and min-sum.

The CUDA kernels are held to these plain passes on the card by
tests/test_torch_cuda.py and chip_smoke.py phase 37.
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
from ldpc_decoder_tpu.ops import decode as D  # noqa: E402
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
from ldpc_decoder_tpu_torch.ops import _kernels  # noqa: E402
from ldpc_decoder_tpu_torch.ops import general as G  # noqa: E402
from ldpc_decoder_tpu_torch.runtime.decoder import LDPCDecoder  # noqa: E402
from ldpc_decoder_tpu_torch.runtime.params import (  # noqa: E402
    DynamicParams,
    StaticParams,
)

FP8 = torch.float8_e5m2
B = 16
# the share of sum-product messages allowed one float8_e5m2 step from JAX's
# (XLA's φ against torch's); on the states below none differs (0 of the
# 17,328 values of each pass, seeds 0-5)
FP8_EDGE_SHARE = 2e-3
# variable degrees 1, 2, 3, 4, 6, 8, 12; check degrees 1, 4, 6, 8, 10, 12
IRREGULAR = ((240, 151, {1: 0.05, 2: 0.25, 3: 0.25, 4: 0.15, 6: 0.1,
                         8: 0.1, 12: 0.1},
              {1: 0.05, 4: 0.15, 6: 0.3, 8: 0.25, 10: 0.15, 12: 0.1}),
             dict(seed=1))


@pytest.fixture(scope="module")
def code():
    args, kw = IRREGULAR
    jcode, pcode = jmake_irregular(*args, **kw), make_irregular_code(*args,
                                                                     **kw)
    jcc, cc = jcompile(jcode), compile_code(pcode)
    t = G.GeneralTables.from_compiled(cc, "cpu")
    return dict(jt=D.DecodeTables.from_compiled(jcc), t=t,
                cedge=torch.from_numpy(G._edge_map(cc.cn_buckets,
                                                   t.n_edges)),
                vedge=torch.from_numpy(G._edge_map(cc.vn_buckets,
                                                   t.n_edges)))


def test_code_spans_degrees_1_to_12(code):
    t = code["t"]
    assert {b.degree for b in t.vn_buckets} == {1, 2, 3, 4, 6, 8, 12}
    assert {b.degree for b in t.cn_buckets} == {1, 4, 6, 8, 10, 12}


# ---- carrying state across ---------------------------------------------------

def _fp8(rng, shape, scale):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
        np.float32)).to(FP8)


def _to_jax(x: torch.Tensor):
    """A port tensor as a JAX array of the same dtype (float8 by its bits)."""
    if x.dtype == FP8:
        return jnp.asarray(x.view(torch.uint8).numpy().view(jnp.float8_e5m2))
    if x.dtype == torch.bfloat16:
        return jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(x.numpy())


def _bits(x) -> np.ndarray:
    """float8_e5m2 values (torch or JAX) as their uint8 bit patterns."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.uint8).numpy()
    return np.asarray(x).view(np.uint8)


def _check_order(c, msgs_v):
    """The port's msgs_v (variable order, plane-major) in the JAX package's
    check-edge order (node-major): msgs_c[t] = msgs_v[perm_v2c[cedge[t]]]."""
    return msgs_v.index_select(0, c["t"].perm_v2c).index_select(0,
                                                                c["cedge"])


def _assert_fp8(port_bits, ref_bits, exact):
    """Signs exact; bits equal (``exact``) or at most one step apart on at
    most FP8_EDGE_SHARE of the values. Returns the share that differs."""
    p, r = port_bits.astype(np.int32), ref_bits.astype(np.int32)
    np.testing.assert_array_equal(p >> 7, r >> 7)
    steps = np.abs((p & 0x7F) - (r & 0x7F))
    share = float((steps != 0).mean())
    if exact:
        np.testing.assert_array_equal(p, r)
    assert steps.max() <= 1 and share <= FP8_EDGE_SHARE, share
    return share


def _state(t, seed, scale=4.0):
    rng = np.random.default_rng(seed)
    return dict(
        msgs_v=_fp8(rng, (t.n_edges, B), scale),
        r_c=_fp8(rng, (t.n_edges, B), scale),
        llr=torch.from_numpy((rng.standard_normal((t.n_vars, B)) * 3).astype(
            np.float32)).to(torch.bfloat16),
        syn=torch.from_numpy((rng.random((t.n_checks, B)) < 0.5).astype(
            np.int8)))


# ---- the plain passes against ops/decode.py ------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_cn_pass_matches_xla(code, seed):
    """The check pass against ``cn_update``."""
    t, st = code["t"], _state(code["t"], seed)
    ref = D.cn_update(_to_jax(_check_order(code, st["msgs_v"])),
                      _to_jax(st["syn"]), code["jt"])
    out = G.cn_pass_general(st["msgs_v"], st["syn"],
                            torch.empty_like(st["r_c"]), t)
    _assert_fp8(_bits(out.index_select(0, code["cedge"])), _bits(ref),
                exact=False)


@pytest.mark.parametrize("seed", [0, 1])
def test_vn_pass_matches_bp_iteration(code, seed):
    """The variable pass against ``bp_iteration``'s: fed the same check
    messages (``cn_update`` of the state, which ``bp_iteration`` computes
    first), its messages in check order and its hard bits."""
    t, jt, st = code["t"], code["jt"], _state(code["t"], seed)
    mc = _to_jax(_check_order(code, st["msgs_v"]))
    syn, llr = _to_jax(st["syn"]), _to_jax(st["llr"])
    r_j = D.cn_update(mc, syn, jt)
    new_j, totals = D.bp_iteration(mc, llr, syn, jt)
    r_c = torch.empty_like(st["r_c"])
    r_c.view(torch.uint8)[code["cedge"]] = torch.from_numpy(
        _bits(r_j).copy())
    bits = torch.full((t.n_vars, B), -1, dtype=torch.int8)
    out = G.vn_pass_general(r_c, st["llr"], torch.empty_like(st["msgs_v"]),
                            t, bits=bits)
    _assert_fp8(_bits(_check_order(code, out)), _bits(new_j), exact=False)
    np.testing.assert_array_equal(bits.numpy(),
                                  np.asarray(D.hard_bits(totals)))


@pytest.mark.parametrize("alpha,beta", [(1.0, 0.0), (0.75, 0.0),
                                        (1.0, 0.5)])
def test_minsum_cn_pass_bitwise(code, alpha, beta):
    """The min-sum check pass against ``cn_update_minsum``, bit for bit."""
    t, st = code["t"], _state(code["t"], 2)
    ref = D.cn_update_minsum(_to_jax(_check_order(code, st["msgs_v"])),
                             _to_jax(st["syn"]), code["jt"], beta, alpha)
    out = G.cn_pass_general_minsum(st["msgs_v"], st["syn"],
                                   torch.empty_like(st["r_c"]), t, alpha,
                                   beta)
    _assert_fp8(_bits(out.index_select(0, code["cedge"])), _bits(ref),
                exact=True)


@pytest.mark.parametrize("clamp", [64.0, 6.0])
def test_minsum_vn_pass_bitwise(code, clamp):
    """The min-sum variable pass against ``vn_update_minsum`` (check
    messages gathered into variable-edge order for it), bit for bit, the
    hard bits from its totals."""
    t, jt, st = code["t"], code["jt"], _state(code["t"], 3)
    r_v = jnp.take(_to_jax(st["r_c"].index_select(0, code["cedge"])),
                   jt.perm_c2v, axis=0)
    ref, totals = D.vn_update_minsum(r_v, _to_jax(st["llr"]), jt, clamp)
    bits = torch.full((t.n_vars, B), -1, dtype=torch.int8)
    out = G.vn_pass_general_minsum(st["r_c"], st["llr"],
                                   torch.empty_like(st["msgs_v"]), t, clamp,
                                   bits=bits)
    _assert_fp8(_bits(out.index_select(0, code["vedge"])), _bits(ref),
                exact=True)
    np.testing.assert_array_equal(bits.numpy(),
                                  np.asarray(D.hard_bits(totals)))


@pytest.mark.parametrize("alg", ["sum-product", "min-sum"])
def test_init_messages_match_xla(code, alg):
    """Every slot of a variable starts at φ(llr) (sum-product) or the llr
    (min-sum), stored in float8_e5m2, as ``init_messages``."""
    t, st = code["t"], _state(code["t"], 4)
    ref = D.init_messages(_to_jax(st["llr"]), code["jt"],
                          dtype=jnp.float8_e5m2, alg=alg)
    mv, rc = G.init_messages_general(st["llr"], t, FP8, alg=alg)
    assert mv.dtype == rc.dtype == FP8
    _assert_fp8(_bits(_check_order(code, mv)), _bits(ref),
                exact=alg == "min-sum")


def test_signed_zero_survives_the_store(code):
    """φ of a large input (up to the clamp at 80: φ(80) = 3.6e-35) rounds
    to a signed zero in float8_e5m2; the sign must survive the store, as
    ``jnp.copysign(...).astype(float8_e5m2)`` keeps it: large check inputs
    give ±0 check messages with the sign rule's signs, and large variable
    totals ±0 variable messages, bit for bit as the JAX ops."""
    t, jt = code["t"], code["jt"]
    rng = np.random.default_rng(5)
    sign = np.where(rng.random((t.n_edges, B)) < 0.5, -1.0, 1.0)
    big = torch.from_numpy((sign * rng.uniform(20, 57344, (t.n_edges, B))
                            ).astype(np.float32)).to(FP8)
    syn = torch.from_numpy((rng.random((t.n_checks, B)) < 0.5).astype(
        np.int8))
    # the check pass: every edge of a check of degree >= 2 sees ext - |m_k|
    # >= 20, so every such message is a signed zero
    out = G.cn_pass_general(big, syn, torch.empty_like(big), t)
    ref = D.cn_update(_to_jax(_check_order(code, big)), _to_jax(syn), jt)
    got = _bits(out.index_select(0, code["cedge"]))
    np.testing.assert_array_equal(got, _bits(ref))
    deg1 = sum(b.count for b in t.cn_buckets if b.degree == 1)
    zeros = got[deg1:] & 0x7F == 0
    assert zeros.all()
    assert (got[deg1:] == 0x80).any() and (got[deg1:] == 0x00).any()
    # the variable pass: llr 0, check messages of one sign and large
    # magnitude, so tot - r_k (the other slots' sum) is large
    r_c = torch.from_numpy(np.where(rng.random((t.n_edges, B)) < 0.5,
                                    -40.0, 40.0).astype(np.float32)).to(FP8)
    llr = torch.zeros((t.n_vars, B), dtype=torch.bfloat16)
    out = G.vn_pass_general(r_c, llr, torch.empty_like(r_c), t)
    new_j, _ = _jax_vn(code, r_c, llr)
    got = _bits(_check_order(code, out))
    np.testing.assert_array_equal(got, _bits(new_j))
    assert (got == 0x80).any() and (got == 0x00).any()


def _jax_vn(code, r_c, llr):
    """``bp_iteration``'s variable half on given check messages (its own
    check half replaced): the total through float8_e5m2, then
    copysign(φ(|t − r|)), as ``ops/decode.py`` computes it."""
    jt = code["jt"]
    r_j = _to_jax(r_c.index_select(0, code["cedge"]))
    r_v = jnp.take(r_j, jt.perm_c2v, axis=0)
    totals = D.vn_totals(r_v, _to_jax(llr), jt)
    t_edge = jnp.take(totals.astype(jnp.float8_e5m2), jt.cn_edge_vnrow,
                      axis=0)
    pre = t_edge.astype(jnp.float32) - r_j.astype(jnp.float32)
    new = jnp.copysign(D.phi_abs(jnp.abs(pre)), pre)
    return new.astype(jnp.float8_e5m2), totals


@pytest.mark.parametrize("k", [1, 3])
def test_run_iterations_bits_match_xla(code, k):
    """k iterations and the parity check on real frames from the same init,
    twice: hard bits and flags exact against ``run_iterations``."""
    jt, t = code["jt"], code["t"]
    args, kw = IRREGULAR
    jcode = jmake_irregular(*args, **kw)
    batch = create_data(jcode, JaxBIAWGN(0.6), 3, B, backend="numpy")
    llr = torch.from_numpy(JaxBIAWGN(0.6).llr_np(batch.values)[
        t.vn_order.numpy()]).to(torch.bfloat16)
    syn = torch.from_numpy(np.ascontiguousarray(
        batch.syndromes[t.cn_order.numpy()], dtype=np.int8))
    mj = D.init_messages(_to_jax(llr), jt, dtype=jnp.float8_e5m2)
    msgs = G.init_messages_general(llr, t, FP8)
    for _ in range(2):
        mj, bits_j, viol_j = D.run_iterations(mj, _to_jax(llr),
                                              _to_jax(syn), jt, k)
        msgs, bits, viol = G.run_iterations_general(msgs, llr, syn, t, k)
        np.testing.assert_array_equal(bits.numpy(), np.asarray(bits_j))
        np.testing.assert_array_equal(viol.numpy(), np.asarray(viol_j))


# ---- the decoder end to end ------------------------------------------------------

N = 3 * B + 5  # refills and a partial last fill
DECODES = {
    # (code constructor, args, sigma)
    "regular": ("regular", ((512, 3, 6), dict(seed=21)), 0.72),
    "irregular": ("irregular", IRREGULAR, 0.6),
}


@pytest.mark.parametrize("alg", ["sum-product", "min-sum"])
@pytest.mark.parametrize("which", sorted(DECODES))
def test_decode_matches_jax(which, alg):
    """``LDPCDecoder(message_dtype="float8_e5m2")`` on a code without QC
    structure against the JAX decoder (its XLA path on the CPU, the path it
    takes for float8_e5m2 there): equal words and per-frame iterations, by
    the rule of test_torch_decoder.py's float32 sum-product decodes (the
    irregular code's degree-1 variables leave frames in error on both)."""
    kind, (args, kw), sigma = DECODES[which]
    jcode = (jmake_regular if kind == "regular" else jmake_irregular)(
        *args, **kw)
    pcode = (make_regular_code if kind == "regular" else make_irregular_code)(
        *args, **kw)
    batch = create_data(jcode, JaxBIAWGN(sigma), 0, N, backend="numpy")
    sp = dict(parallel_factor_user=B, message_dtype="float8_e5m2",
              qc_autodetect=False, algorithm=alg)
    dyn = dict(num_iter_max=60, num_iter_check_parity=5)
    jdec = JaxLDPCDecoder(jcode, JaxBIAWGN(sigma), jparams.StaticParams(**sp))
    assert isinstance(jdec.tables, D.DecodeTables)  # the XLA path
    jres, jst = jdec.decode(jparams.DynamicParams(**dyn), N, batch.values,
                            batch.syndromes)
    dec = LDPCDecoder(pcode, BIAWGNChannel(sigma), StaticParams(**sp),
                      device="cpu")
    assert isinstance(dec.tables, G.GeneralTables)
    assert dec.msg_dtype == FP8 and dec._llr_dtype == torch.bfloat16
    res, st = dec.decode(DynamicParams(**dyn), N, batch.values,
                         batch.syndromes)
    np.testing.assert_array_equal(res, np.asarray(jres))
    np.testing.assert_array_equal(st.iterations, jst.iterations)
    assert st.total_iterations == jst.total_iterations
    assert st.total_supersteps > 3  # refills ran
    if which == "regular":
        assert not np.bitwise_count(batch.ref_bits_packed() ^ res).any()


def test_lane_model_counts_fp8_as_one_byte():
    """The general lane model sizes B with one byte a message, as int8: at
    a memory size where 120 bfloat16 lanes fit, float8_e5m2 and int8 take
    128 and bfloat16 64."""
    code = make_regular_code(512, 3, 6, seed=21)
    e, nv, nc = code.n_edges, code.n_vars, code.n_checks
    per_lane = 2 * e * 2 + e + 3 * nv * 4 + nc
    per_frame = nv * 4 + nc + nv // 8
    table = 3 * e * 4 + 2 * nv * 4 + 2 * nc * 4
    mem = int((per_lane + 4 * per_frame) * 120 / 0.9) + table + 1000
    lanes = {}
    for dt, alg in (("float8_e5m2", "sum-product"), ("int8", "min-sum"),
                    ("bfloat16", "sum-product")):
        lanes[dt] = LDPCDecoder(code, BIAWGNChannel(0.7), StaticParams(
            message_dtype=dt, algorithm=alg, qc_autodetect=False,
            device_memory_bytes=mem, max_log_parallel_factor_user=12),
            device="cpu").parallel_factor()
    assert lanes == {"float8_e5m2": 128, "int8": 128, "bfloat16": 64}


def test_fp8_launches_count_apart():
    """The general kernels' float8_e5m2 launches count under their own
    names, so a run shows that the float8 instantiations ran."""
    for name in ("cn_general_fp8", "vn_general_fp8", "cn_general_minsum_fp8",
                 "vn_general_minsum_fp8", "cn_general_minsum_fp8_vec"):
        assert name in _kernels.launch_counts
    assert _kernels._fp8("cn_general_minsum", FP8) == "cn_general_minsum_fp8"
    assert _kernels._fp8("vn_general", torch.bfloat16) == "vn_general"
    assert _kernels.minsum_vec_lanes(FP8, 6) == 16
    assert [_kernels.vec_lanes(FP8, d) for d in (1, 3, 4, 6, 12, 32)] == [
        16, 16, 16, 8, 4, 2]
