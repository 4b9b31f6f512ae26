"""float8_e5m2 messages on the port's QC passes against the JAX package's.

The JAX passes (``ops/qc_pallas.py``, ``ops/qc_pallas_grouped.py``) run as
the JAX package's own tests run them on the CPU (Pallas interpret mode);
the port's passes take their plain PyTorch versions on CPU tensors. Both get
the same state, made from a seed with numpy: the grouped family on the small
p41-shaped code (check degrees 3, 6 and 7, a degree-1 variable group), the
regular family on the all-ones (3,6) base at Z = 64. numpy has no float8
type, so messages cross as uint8 bit patterns
(``ldpc_decoder_tpu_torch.convert.fp8_bits``) and are compared as such.

Tolerance, stated per rule:

- min-sum: bitwise wherever α = 1 or β = 0. With α ≠ 1 and β ≠ 0 XLA:CPU
  fuses α·m − β into one multiply-add that the port rounds twice (ROADMAP
  Queue 3), so a message may sit one e5m2 step away;
- sum-product: XLA:CPU's φ differs from torch's by up to 1.74e-5 relative
  (ROADMAP Queue 3), which moves a value across an e5m2 rounding boundary
  now and then: messages are equal except a share of at most
  ``SP_SHARE`` = 1e-3, each of those one e5m2 step away;
- signs, hard bits and parity flags are exact throughout (the sign of a
  φ that underflows to ±0 in the grouped family included);
- decodes: equal words, and per-frame iterations equal or one check
  period apart.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from ldpc_decoder_tpu.channels import BIAWGNChannel as JaxBIAWGN  # noqa: E402
from ldpc_decoder_tpu.codes.protographs import p41_code as jax_p41  # noqa: E402
from ldpc_decoder_tpu.codes.qc import make_qc_code as jax_make_qc  # noqa: E402
from ldpc_decoder_tpu.ops import qc_pallas as jp  # noqa: E402
from ldpc_decoder_tpu.ops import qc_pallas_grouped as jg  # noqa: E402
from ldpc_decoder_tpu.ops.qc_decode import (  # noqa: E402
    QCDecodeTables as JaxQCDecodeTables,
)
from ldpc_decoder_tpu.runtime import params as jparams  # noqa: E402
from ldpc_decoder_tpu.runtime.datagen import create_data  # noqa: E402
from ldpc_decoder_tpu.runtime.decoder import (  # noqa: E402
    LDPCDecoder as JaxLDPCDecoder,
)

from ldpc_decoder_tpu_torch.channels import BIAWGNChannel  # noqa: E402
from ldpc_decoder_tpu_torch.codes.generate import make_regular_code  # noqa: E402
from ldpc_decoder_tpu_torch.codes.protographs import p41_code  # noqa: E402
from ldpc_decoder_tpu_torch.codes.qc import make_qc_code  # noqa: E402
from ldpc_decoder_tpu_torch.convert import (  # noqa: E402
    fp8_bits,
    fp8_from_bits,
    grouped_state_from_jax,
    grouped_state_to_jax,
    regular_state_from_jax,
    structure_from_numpy,
)
from ldpc_decoder_tpu_torch.ops import qc_grouped as qg  # noqa: E402
from ldpc_decoder_tpu_torch.ops import qc_regular as qr  # noqa: E402
from ldpc_decoder_tpu_torch.ops.phi import (  # noqa: E402
    HIGH_THRESHOLD,
    PHI_HIGH_BY_DTYPE,
    phi_high,
)
from ldpc_decoder_tpu_torch.ops.qc_decode import (  # noqa: E402
    QCDecodeTables,
    llr_dtype,
)
from ldpc_decoder_tpu_torch.runtime.decoder import LDPCDecoder  # noqa: E402
from ldpc_decoder_tpu_torch.runtime.params import (  # noqa: E402
    DynamicParams,
    StaticParams,
)

B = 8
FP8 = torch.float8_e5m2
JFP8 = jnp.dtype(jnp.float8_e5m2)
CLAMP = 20.0
SP_SHARE = 1e-3
# per-degree α of the p41 check degrees (3, 6, 7), with the fallback
ALPHA = ((3, 0.8), (6, 0.75), (7, 0.75), (0, 0.8))
# (alg, min-sum alpha, beta, bitwise)
RULES = {
    "sum-product": ("sum-product", 1.0, 0.0, False),
    "min-sum-offset": ("min-sum", 1.0, 0.5, True),
    "min-sum-alpha-table": ("min-sum", ALPHA, 0.0, True),
    "min-sum-alpha-and-offset": ("min-sum", ALPHA, 0.5, False),
}


def _port_qct(js, n_erased=0):
    s = structure_from_numpy(js.Z, js.n_base_rows, js.n_base_cols,
                             js.edge_row, js.edge_col, js.edge_shift)
    return QCDecodeTables.from_structure(s, n_erased, "cpu")


@pytest.fixture(scope="module")
def grouped():
    jcode, js = jax_p41(Z=128, m=4, coarse=64, fine_mod=16)
    jt = jg.GroupedQCPallasTables.from_qc_tables(
        JaxQCDecodeTables.from_structure(js, jcode.n_erased_vars), 1)
    t = qg.GroupedQCTables.from_qc_tables(_port_qct(js, jcode.n_erased_vars))
    ch = JaxBIAWGN(0.7)
    batch = create_data(jcode, ch, 0, B)
    llr2d = ch.llr_np(batch.values)[np.asarray(jt.vn_order)]
    syn2d = batch.syndromes[np.asarray(jt.cn_order)]
    return dict(jt=jt, t=t, llr2d=_bf16(llr2d), syn2d=syn2d)


@pytest.fixture(scope="module")
def regular():
    jcode, js = jax_make_qc(np.ones((3, 6), np.int8), Z=64, seed=2)
    jt = jp.QCPallasTables.from_qc_tables(
        JaxQCDecodeTables.from_structure(js), msg_bytes=1)
    t = qr.QCRegularTables.from_qc_tables(_port_qct(js))
    ch = JaxBIAWGN(0.8)
    batch = create_data(jcode, ch, 0, B)
    llr2d = ch.llr_np(batch.values)[np.asarray(jt.vn_order)]
    syn2d = batch.syndromes[np.asarray(jt.cn_order)]
    return dict(jt=jt, t=t, llr2d=_bf16(llr2d), syn2d=syn2d)


def _bf16(x):
    """float32 values rounded to bfloat16 (the LLR state of fp8 messages),
    kept as float32."""
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
        torch.bfloat16).float().numpy()


def _fp8_msgs(rng, shape):
    """Bit patterns of float8_e5m2 messages: normals up to about ±40, ±0,
    subnormals and exact ties of the float32 source."""
    x = (rng.standard_normal(shape) * 6).astype(np.float32)
    pick = rng.random(shape)
    x[pick < 0.05] = 0.0
    x[(pick >= 0.05) & (pick < 0.1)] = -0.0
    tiny = (pick >= 0.1) & (pick < 0.15)
    x[tiny] = np.float32(2.0 ** -16) * rng.integers(-3, 4, tiny.sum())
    return fp8_bits(torch.from_numpy(x).to(FP8))


def _llr(rng, shape, scale=12.0):
    return _bf16(rng.standard_normal(shape) * scale)


def _jax8(bits):
    return jnp.asarray(np.ascontiguousarray(bits).view(JFP8))


def _torch_bf16(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
        torch.bfloat16)


def _fresh8(fresh):
    return jnp.broadcast_to(jnp.asarray(fresh, jnp.float32)[None, :], (8, B))


def _assert_fp8(port, ref, share):
    """Bit patterns equal, or (share > 0) equal except a share <= ``share``
    of values one e5m2 step apart with the same sign."""
    port, ref = np.asarray(port, np.uint8), np.asarray(ref, np.uint8)
    assert port.shape == ref.shape
    diff = port != ref
    if share == 0.0:
        assert not diff.any(), f"{diff.sum()} of {diff.size} values differ"
        return
    assert not ((port ^ ref) & 0x80).any(), "signs differ"
    steps = np.abs((port & 0x7F).astype(np.int32)
                   - (ref & 0x7F).astype(np.int32))
    assert steps.max() <= 1, f"{steps.max()} e5m2 steps apart"
    assert diff.mean() <= share, f"share {diff.mean():.2e} > {share}"


def _share(bitwise):
    return 0.0 if bitwise else SP_SHARE


def test_phi_clamps_match_jax():
    """The regular family's φ clamp per dtype is the JAX kernels' table;
    the LLR state of 1-byte messages is bfloat16."""
    assert jp.PHI_HIGH_BY_DTYPE == {"float8_e5m2": 10.0}
    assert PHI_HIGH_BY_DTYPE == {FP8: 10.0}
    for td, jd in ((FP8, jnp.float8_e5m2), (torch.bfloat16, jnp.bfloat16),
                   (torch.float32, jnp.float32)):
        assert phi_high(td) == jp._phi_high(jd)
    assert phi_high(torch.bfloat16) == HIGH_THRESHOLD == 80.0
    assert llr_dtype(FP8) == llr_dtype(torch.int8) == torch.bfloat16


def test_fp8_bits_round_trip():
    x = torch.tensor([0.0, -0.0, 1.125, -57344.0, 2.0 ** -16, 7e4, -1e6])
    bits = fp8_bits(x.to(FP8))
    # 1.125 is the tie of 1 and 1.25: to even; 7e4 and -1e6 overflow to inf
    np.testing.assert_array_equal(
        bits, [0x00, 0x80, 0x3C, 0xFB, 0x01, 0x7C, 0xFC])
    np.testing.assert_array_equal(
        np.asarray(_jax8(bits).astype(jnp.float32)),
        fp8_from_bits(bits).float().numpy())
    np.testing.assert_array_equal(
        fp8_bits(jnp.asarray(x.numpy()).astype(jnp.float8_e5m2)), bits)


# ---- grouped family ---------------------------------------------------------

@pytest.mark.parametrize("rule", sorted(RULES))
def test_grouped_cn_fp8_matches_jax(grouped, rule):
    jt, t = grouped["jt"], grouped["t"]
    alg, alpha, beta, bitwise = RULES[rule]
    rng = np.random.default_rng(31)
    mv = _fp8_msgs(rng, (t.nb, t.Z, B))
    syn = (rng.random((t.R, t.Z, B)) < 0.5).astype(np.int8)
    mv_j, rc_j = grouped_state_to_jax(mv, np.zeros_like(mv), jt, t)
    out_j = jg.cn_pass_grouped(_jax8(mv_j), jnp.asarray(syn), _jax8(rc_j),
                               jt, alg=alg, beta=beta, alpha=alpha)
    _, ref = grouped_state_from_jax(mv_j, fp8_bits(out_j), jt, t)
    r_c = torch.empty((t.nb, t.Z, B), dtype=FP8)
    if alg == "min-sum":
        out = qg.cn_pass_grouped_minsum(fp8_from_bits(mv),
                                        torch.from_numpy(syn), r_c, t,
                                        alpha, beta)
    else:
        out = qg.cn_pass_grouped(fp8_from_bits(mv), torch.from_numpy(syn),
                                 r_c, t)
    assert out is r_c  # written in place
    _assert_fp8(fp8_bits(out), ref, _share(bitwise))
    if alg == "sum-product":  # grouped φ runs to 80: ±0 and subnormals
        mag = fp8_bits(out) & 0x7F
        assert (mag == 0).any() and ((mag > 0) & (mag < 4)).any()


@pytest.mark.parametrize("emit,fresh,include_d1", [
    (False, False, False),  # plain iteration: degree-1 groups skipped
    (True, True, False),    # emit with refilled lanes (k = 1)
    (False, True, True),    # first iteration after a refill
])
@pytest.mark.parametrize("alg", ["sum-product", "min-sum"])
def test_grouped_vn_fp8_matches_jax(grouped, alg, emit, fresh, include_d1):
    jt, t = grouped["jt"], grouped["t"]
    rng = np.random.default_rng(32)
    rc = _fp8_msgs(rng, (t.nb, t.Z, B))
    mv = _fp8_msgs(rng, (t.nb, t.Z, B))
    llr = _llr(rng, (t.C, t.Z, B))
    fr = rng.random(B) < 0.5
    mv_j, rc_j = grouped_state_to_jax(mv, rc, jt, t)
    out_j, bits_j = jg.vn_pass_grouped(
        _jax8(rc_j), jnp.asarray(llr, jnp.bfloat16), _jax8(mv_j), jt,
        emit_bits=emit, alg=alg, clamp=CLAMP,
        fresh8=_fresh8(fr) if fresh else None, include_d1=include_d1)
    ref, _ = grouped_state_from_jax(fp8_bits(out_j), rc_j, jt, t)

    msgs_v = fp8_from_bits(mv)
    bits = torch.full((t.C, t.Z, B), -1, dtype=torch.int8) if emit else None
    kw = dict(bits=bits, fresh=torch.from_numpy(fr) if fresh else None,
              include_d1=include_d1)
    if alg == "min-sum":
        out = qg.vn_pass_grouped_minsum(fp8_from_bits(rc), _torch_bf16(llr),
                                        msgs_v, t, CLAMP, **kw)
    else:
        out = qg.vn_pass_grouped(fp8_from_bits(rc), _torch_bf16(llr), msgs_v,
                                 t, **kw)
    assert out is msgs_v
    _assert_fp8(fp8_bits(out), ref, _share(alg == "min-sum"))
    if not (emit or include_d1):  # skipped degree-1 blocks are untouched
        d1 = t.col_groups[0]
        assert d1.degree == 1
        sl = slice(d1.block_start, d1.block_start + d1.count)
        np.testing.assert_array_equal(fp8_bits(out)[sl], mv[sl])
    if emit:
        np.testing.assert_array_equal(bits.numpy(), np.asarray(bits_j))


@pytest.mark.parametrize("alg", ["sum-product", "min-sum"])
def test_grouped_init_fp8_matches_jax(grouped, alg):
    """Sum-product: φ(llr) with φ's input up to 80; min-sum: the llr, clipped
    in the degree-1 group only."""
    jt, t = grouped["jt"], grouped["t"]
    llr = _llr(np.random.default_rng(33), (t.C, t.Z, B), 36.0)
    jm, jr = jg.init_messages_qc_grouped(
        jnp.asarray(llr.reshape(-1, B), jnp.bfloat16), jt, jnp.float8_e5m2,
        alg=alg, clamp=CLAMP)
    ref, _ = grouped_state_from_jax(fp8_bits(jm), fp8_bits(jr), jt, t)
    mv, rc = qg.init_messages_qc_grouped(_torch_bf16(llr), t, FP8, alg=alg,
                                         clamp=CLAMP)
    assert mv.dtype == rc.dtype == FP8
    _assert_fp8(fp8_bits(mv), ref, _share(alg == "min-sum"))


@pytest.mark.parametrize("alg,k", [("sum-product", 1), ("sum-product", 4),
                                   ("min-sum", 4)])
def test_grouped_run_iterations_fp8_matches_jax(grouped, alg, k):
    """A superstep on real frames with refilled lanes (a retired frame's
    state in them): hard bits and flags exact, messages within the rule's
    tolerance."""
    jt, t = grouped["jt"], grouped["t"]
    ms = dict(alg=alg, beta=0.5, clamp=CLAMP) if alg == "min-sum" else {}
    init = dict(alg=alg, clamp=CLAMP)
    llr, syn = grouped["llr2d"], grouped["syn2d"]
    stale = _bf16(-2.0 * llr + 1.0)
    fresh = np.array([1, 0, 0, 1, 1, 0, 1, 0], bool)
    jm = jg.init_messages_qc_grouped(jnp.asarray(stale, jnp.bfloat16), jt,
                                     jnp.float8_e5m2, **init)
    (jmv, jrc), bits_j, viol_j = jg.run_iterations_qc_grouped(
        jm, jnp.asarray(llr, jnp.bfloat16), jnp.asarray(syn), jt, k,
        fresh=jnp.asarray(fresh.astype(np.int8)), **ms)

    def t3(x, rows):
        return x.view(rows, t.Z, B)

    msgs = qg.init_messages_qc_grouped(t3(_torch_bf16(stale), t.C), t, FP8,
                                       **init)
    (mv, _), bits, viol = qg.run_iterations_qc_grouped(
        msgs, t3(_torch_bf16(llr), t.C), t3(torch.from_numpy(syn), t.R), t,
        k, fresh=torch.from_numpy(fresh), **ms)
    np.testing.assert_array_equal(bits.numpy().reshape(-1, B),
                                  np.asarray(bits_j))
    np.testing.assert_array_equal(viol.numpy(), np.asarray(viol_j))
    ref, _ = grouped_state_from_jax(fp8_bits(jmv), fp8_bits(jrc), jt, t)
    _assert_fp8(fp8_bits(mv), ref, _share(alg == "min-sum"))


# ---- regular family ----------------------------------------------------------

@pytest.mark.parametrize("rule", sorted(RULES))
def test_regular_cn_fp8_matches_jax(regular, rule):
    jt, t = regular["jt"], regular["t"]
    alg, alpha, beta, bitwise = RULES[rule]
    rng = np.random.default_rng(41)
    mv = _fp8_msgs(rng, (t.C, t.d_v, t.Z, B))
    syn = (rng.random((t.R, t.Z, B)) < 0.5).astype(np.int8)
    ref = jp.cn_pass(_jax8(mv), jnp.asarray(syn), jt, alg=alg, beta=beta,
                     alpha=alpha)
    r_c = torch.empty((t.R, t.d_c, t.Z, B), dtype=FP8)
    if alg == "min-sum":
        out = qr.cn_pass_regular_minsum(fp8_from_bits(mv),
                                        torch.from_numpy(syn), r_c, t,
                                        alpha, beta)
    else:
        out = qr.cn_pass_regular(fp8_from_bits(mv), torch.from_numpy(syn),
                                 r_c, t)
    assert out is r_c
    _assert_fp8(fp8_bits(out), fp8_bits(ref), _share(bitwise))
    if alg == "sum-product":  # φ's input stops at 10: no subnormal, no ±0
        mag = fp8_bits(out) & 0x7F
        assert mag.min() == 6  # φ(10) = 9.08e-5 rounds to 1.5 · 2^-14


@pytest.mark.parametrize("emit,fresh", [
    (False, False),  # plain iteration
    (True, True),    # emit with refilled lanes (k = 1)
    (False, True),   # first iteration after a refill
])
@pytest.mark.parametrize("alg", ["sum-product", "min-sum"])
def test_regular_vn_fp8_matches_jax(regular, alg, emit, fresh):
    jt, t = regular["jt"], regular["t"]
    rng = np.random.default_rng(42)
    rc = _fp8_msgs(rng, (t.R, t.d_c, t.Z, B))
    llr = _llr(rng, (t.C, t.Z, B))
    fr = rng.random(B) < 0.5
    ref, bits_j = jp.vn_pass(_jax8(rc), jnp.asarray(llr, jnp.bfloat16), jt,
                             emit_bits=emit, alg=alg, clamp=CLAMP,
                             fresh8=_fresh8(fr) if fresh else None)
    msgs_v = torch.empty((t.C, t.d_v, t.Z, B), dtype=FP8)
    bits = torch.full((t.C, t.Z, B), -1, dtype=torch.int8) if emit else None
    kw = dict(bits=bits, fresh=torch.from_numpy(fr) if fresh else None)
    if alg == "min-sum":
        out = qr.vn_pass_regular_minsum(fp8_from_bits(rc), _torch_bf16(llr),
                                        msgs_v, t, CLAMP, **kw)
    else:
        out = qr.vn_pass_regular(fp8_from_bits(rc), _torch_bf16(llr), msgs_v,
                                 t, **kw)
    assert out is msgs_v
    _assert_fp8(fp8_bits(out), fp8_bits(ref), _share(alg == "min-sum"))
    if emit:
        np.testing.assert_array_equal(bits.numpy(), np.asarray(bits_j))


@pytest.mark.parametrize("alg", ["sum-product", "min-sum"])
def test_regular_init_fp8_matches_jax(regular, alg):
    """Sum-product: φ(llr) with φ's input clamped at 10; min-sum: the llr,
    unclipped."""
    jt, t = regular["jt"], regular["t"]
    llr = _llr(np.random.default_rng(43), (t.C, t.Z, B), 36.0)
    jm = jp.init_messages_qc_pallas(
        jnp.asarray(llr.reshape(-1, B), jnp.bfloat16), jt, jnp.float8_e5m2,
        alg=alg)
    ref, _ = regular_state_from_jax(fp8_bits(jm), fp8_bits(jm), t)
    mv, rc = qr.init_messages_qc_regular(_torch_bf16(llr), t, FP8, alg=alg,
                                         clamp=CLAMP)
    assert mv.dtype == rc.dtype == FP8
    _assert_fp8(fp8_bits(mv), ref, _share(alg == "min-sum"))


@pytest.mark.parametrize("alg,k", [("sum-product", 1), ("sum-product", 4),
                                   ("min-sum", 4)])
def test_regular_run_iterations_fp8_matches_jax(regular, alg, k):
    jt, t = regular["jt"], regular["t"]
    ms = dict(alg=alg, beta=0.5, clamp=CLAMP) if alg == "min-sum" else {}
    llr, syn = regular["llr2d"], regular["syn2d"]
    stale = _bf16(-2.0 * llr + 1.0)
    fresh = np.array([1, 0, 0, 1, 1, 0, 1, 0], bool)
    jm = jp.init_messages_qc_pallas(jnp.asarray(stale, jnp.bfloat16), jt,
                                    jnp.float8_e5m2, alg=alg)
    jmv, bits_j, viol_j = jp.run_iterations_qc_pallas(
        jm, jnp.asarray(llr, jnp.bfloat16), jnp.asarray(syn), jt, k,
        fresh=jnp.asarray(fresh.astype(np.int8)), **ms)
    msgs = qr.init_messages_qc_regular(
        _torch_bf16(stale).view(t.C, t.Z, B), t, FP8, alg=alg)
    (mv, _), bits, viol = qr.run_iterations_qc_regular(
        msgs, _torch_bf16(llr).view(t.C, t.Z, B),
        torch.from_numpy(syn).view(t.R, t.Z, B), t, k,
        fresh=torch.from_numpy(fresh), **ms)
    np.testing.assert_array_equal(bits.numpy().reshape(-1, B),
                                  np.asarray(bits_j))
    np.testing.assert_array_equal(viol.numpy(), np.asarray(viol_j))
    ref, _ = regular_state_from_jax(fp8_bits(jmv), fp8_bits(jmv), t)
    _assert_fp8(fp8_bits(mv), ref, _share(alg == "min-sum"))


# ---- both families -------------------------------------------------------------

@pytest.mark.parametrize("family", ["grouped", "regular"])
@pytest.mark.parametrize("alg", ["sum-product", "min-sum"])
def test_fp8_burst_prefix_identity(grouped, regular, family, alg):
    """burst(b) then run(k) equals run(b + k) bit for bit."""
    mod, st = (qg, grouped) if family == "grouped" else (qr, regular)
    t = st["t"]
    init = getattr(mod, f"init_messages_qc_{family}")
    run = getattr(mod, f"run_iterations_qc_{family}")
    burst = getattr(mod, f"burst_iterations_qc_{family}")
    ms = dict(alg=alg, beta=0.5, clamp=CLAMP, alpha=ALPHA)
    llr = _torch_bf16(st["llr2d"]).view(t.C, t.Z, B)
    syn = torch.from_numpy(st["syn2d"]).view(t.R, t.Z, B)
    m0 = init(llr, t, FP8, alg=alg, clamp=CLAMP)
    m1 = tuple(x.clone() for x in m0)
    burst(m1, llr, syn, t, 3, **ms)
    m1, bits1, viol1 = run(m1, llr, syn, t, 2, **ms)
    m2 = tuple(x.clone() for x in m0)
    m2, bits2, viol2 = run(m2, llr, syn, t, 5, **ms)
    for a, b in zip(m1, m2):
        np.testing.assert_array_equal(fp8_bits(a), fp8_bits(b))
    assert torch.equal(bits1, bits2)
    assert torch.equal(viol1, viol2)


# ---- decoder -----------------------------------------------------------------

N_DECODE = 40
B_DECODE = 8
K_DECODE = 5


@pytest.mark.parametrize("case", [
    "regular-sum-product", "regular-min-sum", "p41-sum-product"])
def test_decode_fp8_matches_jax(case):
    """float8_e5m2 decodes end to end against the JAX decoder (its Pallas
    kernels in interpret mode) with refills: the regular (3,6) base at
    Z = 64 keeps the regular family, p41 at Z = 128 the grouped one. Equal
    words; per-frame iterations equal or one check period apart."""
    family, alg = case.split("-", 1)
    if family == "regular":
        jcode, js = jax_make_qc(np.ones((3, 6), np.int8), Z=64, seed=2)
        code, s = make_qc_code(np.ones((3, 6), np.int8), Z=64, seed=2)
        sigma, want = 0.75, qr.QCRegularTables
    else:
        jcode, js = jax_p41(Z=128, m=4, coarse=64, fine_mod=16)
        code, s = p41_code(Z=128, m=4, coarse=64, fine_mod=16)
        sigma, want = 0.7, qg.GroupedQCTables
    batch = create_data(jcode, JaxBIAWGN(sigma), 0, N_DECODE)
    kw = dict(parallel_factor_user=B_DECODE, message_dtype="float8_e5m2",
              algorithm=alg)
    dyn = dict(num_iter_max=40, num_iter_check_parity=K_DECODE)
    jdec = JaxLDPCDecoder(jcode, JaxBIAWGN(sigma),
                          jparams.StaticParams(**kw), qc=js)
    jres, jst = jdec.decode(jparams.DynamicParams(**dyn), N_DECODE,
                            batch.values, batch.syndromes)
    dec = LDPCDecoder(code, BIAWGNChannel(sigma), StaticParams(**kw), qc=s,
                      device="cpu")
    assert isinstance(dec.tables, want)
    assert dec._llr_dtype == torch.bfloat16
    res, st = dec.decode(DynamicParams(**dyn), N_DECODE, batch.values,
                         batch.syndromes)
    np.testing.assert_array_equal(res, np.asarray(jres))
    gap = np.abs(st.iterations.astype(np.int64) - np.asarray(jst.iterations))
    assert gap.max() <= K_DECODE, gap
    assert st.total_supersteps > 3  # refills ran


def test_fp8_without_qc_structure_raises():
    """The general path has no float8_e5m2 kernels: an explicit refusal,
    never a fallback; detection still runs first."""
    code = make_regular_code(256, 3, 6, seed=7)
    with pytest.raises(NotImplementedError, match="float8_e5m2"):
        LDPCDecoder(code, BIAWGNChannel(0.8),
                    StaticParams(message_dtype="float8_e5m2"), device="cpu")
    qcode, _ = make_qc_code(np.ones((3, 6), np.int8), Z=64, seed=2)
    with pytest.raises(NotImplementedError, match="float8_e5m2"):
        LDPCDecoder(qcode, BIAWGNChannel(0.8), StaticParams(
            message_dtype="float8_e5m2", qc_autodetect=False), device="cpu")
    dec = LDPCDecoder(qcode, BIAWGNChannel(0.8), StaticParams(
        message_dtype="float8_e5m2", parallel_factor_user=8), device="cpu")
    assert isinstance(dec.tables, qr.QCRegularTables)  # detected


def test_lane_model_counts_fp8_as_one_byte(regular):
    """float8_e5m2 takes one byte per message in the lane model, as int8."""
    code, _ = make_qc_code(np.ones((3, 6), np.int8), Z=64, seed=2)
    lanes = {}
    for dt, alg in (("float8_e5m2", "sum-product"), ("int8", "min-sum"),
                    ("bfloat16", "sum-product")):
        lanes[dt] = LDPCDecoder(code, BIAWGNChannel(0.8), StaticParams(
            message_dtype=dt, algorithm=alg, device_memory_bytes=1 << 24,
            max_log_parallel_factor_user=30), device="cpu").parallel_factor()
    assert lanes["float8_e5m2"] == lanes["int8"] > lanes["bfloat16"]
