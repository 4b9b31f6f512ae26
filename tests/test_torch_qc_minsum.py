"""The port's QC min-sum passes, init and runners against the JAX package's.

The JAX passes (``ops/qc_pallas_grouped.py``, ``ops/qc_pallas.py``) run as
the JAX package's own tests run them on the CPU (Pallas interpret mode);
the port's passes take their plain PyTorch versions on CPU tensors. Both
get the same state, made from a seed with numpy and carried across by
``ldpc_decoder_tpu_torch.convert``: the grouped family on the small
p41-shaped code (check degrees 3, 6 and 7, a degree-1 variable group) in
float32, bfloat16 and int8, the regular family on the all-ones (3,6) base
at Z = 64 in float32 and bfloat16. Message values sit on a coarse grid
(quarter steps, int8 steps of 1/qscale) so that ties between minima, zeros
of both signs and clipped values all occur.

Tolerance: bitwise wherever α = 1 or β = 0. XLA:CPU contracts the check
rule's α·m − β into one fused multiply-add and the port rounds the product
and the difference separately (ROADMAP Queue 3), so with α ≠ 1 and β ≠ 0
the float32 messages differ by at most 2 ulps of the largest α·|m| (bound
below: 4 ulps of the largest |m|), bfloat16 ones by at most one bfloat16
ulp beyond that, int8 ones by at most one quantization step; signs are
exact. Hard bits and parity flags are exact throughout.
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
from ldpc_decoder_tpu.runtime.datagen import create_data  # noqa: E402

from ldpc_decoder_tpu_torch.convert import (  # noqa: E402
    grouped_state_from_jax,
    grouped_state_to_jax,
    regular_state_from_jax,
    structure_from_numpy,
)
from ldpc_decoder_tpu_torch.ops import qc_grouped as qg  # noqa: E402
from ldpc_decoder_tpu_torch.ops import qc_regular as qr  # noqa: E402
from ldpc_decoder_tpu_torch.ops.qc_decode import QCDecodeTables  # noqa: E402

B = 8
QSCALE = 4.0
CLAMP = 20.0
# per-degree α of the p41 check degrees (3, 6, 7), with the fallback
ALPHA = ((3, 0.8), (6, 0.75), (7, 0.75), (0, 0.8))
# (alpha, beta, bitwise): offset min-sum at the defaults, the α table with
# no offset, and both (held to the FMA bound)
RULES = {
    "offset": (1.0, 0.5, True),
    "alpha-table": (ALPHA, 0.0, True),
    "alpha-and-offset": (ALPHA, 0.5, False),
}
JAX_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
              "int8": jnp.int8}
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "int8": torch.int8}


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
    return dict(jt=jt, t=t, llr2d=llr2d, syn2d=syn2d)


@pytest.fixture(scope="module")
def regular():
    jcode, js = jax_make_qc(np.ones((3, 6), np.int8), Z=64, seed=2)
    jt = jp.QCPallasTables.from_qc_tables(JaxQCDecodeTables.from_structure(js))
    t = qr.QCRegularTables.from_qc_tables(_port_qct(js))
    ch = JaxBIAWGN(0.8)
    batch = create_data(jcode, ch, 0, B)
    llr2d = ch.llr_np(batch.values)[np.asarray(jt.vn_order)]
    syn2d = batch.syndromes[np.asarray(jt.cn_order)]
    return dict(jt=jt, t=t, llr2d=llr2d, syn2d=syn2d)


def _msgs(rng, shape, dtype):
    """Messages on a coarse grid: int8 in [-12, 12], floats in quarter
    steps up to about ±32 (ties, ±0 and values beyond CLAMP occur)."""
    if dtype == "int8":
        return rng.integers(-12, 13, shape).astype(np.int8)
    return (np.round(rng.standard_normal(shape) * 32) / 4).astype(np.float32)


def _llr(rng, shape):
    return (rng.standard_normal(shape) * 12).astype(np.float32)


def _jax(x, dtype):
    return jnp.asarray(x, JAX_DTYPES[dtype])


def _torch(x, dtype):
    return torch.from_numpy(np.ascontiguousarray(x)).to(TORCH_DTYPES[dtype])


def _np(x):
    """A torch tensor or a JAX array as numpy: float32 (bf16 widened
    exactly) or int8."""
    if isinstance(x, torch.Tensor):
        x = x.float() if x.dtype == torch.bfloat16 else x
        return x.numpy()
    x = np.asarray(x)
    return x if x.dtype == np.int8 else x.astype(np.float32)


def _assert_msgs(port, ref, bitwise, dtype, scale):
    port, ref = _np(port), _np(ref)
    assert port.dtype == ref.dtype
    if bitwise:
        as_int = np.int8 if port.dtype == np.int8 else np.int32
        np.testing.assert_array_equal(port.view(as_int), ref.view(as_int))
        return
    if dtype == "int8":
        assert np.abs(port.astype(np.int32) - ref.astype(np.int32)).max() <= 1
        return
    np.testing.assert_array_equal(np.signbit(port), np.signbit(ref))
    atol = 4 * np.finfo(np.float32).eps * scale
    rtol = 2.0 ** -8 if dtype == "bfloat16" else 0.0
    np.testing.assert_allclose(port, ref, rtol=rtol, atol=atol)


def _llr_dtype(dtype):
    return "bfloat16" if dtype == "int8" else dtype


def _fresh8(fresh):
    return jnp.broadcast_to(jnp.asarray(fresh, jnp.float32)[None, :], (8, B))


# ---- grouped family ---------------------------------------------------------

@pytest.mark.parametrize("rule", sorted(RULES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_grouped_cn_minsum_matches_jax(grouped, dtype, rule):
    jt, t = grouped["jt"], grouped["t"]
    alpha, beta, bitwise = RULES[rule]
    rng = np.random.default_rng(11)
    mv = _msgs(rng, (t.nb, t.Z, B), dtype)
    syn = (rng.random((t.R, t.Z, B)) < 0.5).astype(np.int8)
    mv_j, rc_j = grouped_state_to_jax(mv, np.zeros_like(mv), jt, t)
    out_j = jg.cn_pass_grouped(_jax(mv_j, dtype), jnp.asarray(syn),
                               _jax(rc_j, dtype), jt, alg="min-sum",
                               beta=beta, alpha=alpha, qscale=QSCALE)
    _, ref = grouped_state_from_jax(mv_j, _np(out_j), jt, t)
    r_c = torch.empty((t.nb, t.Z, B), dtype=TORCH_DTYPES[dtype])
    out = qg.cn_pass_grouped_minsum(_torch(mv, dtype), torch.from_numpy(syn),
                                    r_c, t, alpha, beta, QSCALE)
    assert out is r_c  # written in place
    _assert_msgs(out, ref, bitwise, dtype, np.abs(_np(_torch(mv, dtype))).max())


@pytest.mark.parametrize("emit,fresh,include_d1", [
    (False, False, False),  # plain iteration: degree-1 groups skipped
    (True, True, False),    # emit with refilled lanes (k = 1)
    (False, True, True),    # first iteration after a refill
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_grouped_vn_minsum_matches_jax(grouped, dtype, emit, fresh,
                                       include_d1):
    jt, t = grouped["jt"], grouped["t"]
    rng = np.random.default_rng(12)
    rc = _msgs(rng, (t.nb, t.Z, B), dtype)
    mv = _msgs(rng, (t.nb, t.Z, B), dtype)
    llr = _torch(_llr(rng, (t.C, t.Z, B)), _llr_dtype(dtype))
    fr = rng.random(B) < 0.5
    mv_j, rc_j = grouped_state_to_jax(mv, rc, jt, t)
    out_j, bits_j = jg.vn_pass_grouped(
        _jax(rc_j, dtype), jnp.asarray(_np(llr), JAX_DTYPES[_llr_dtype(
            dtype)]), _jax(mv_j, dtype), jt, emit_bits=emit, alg="min-sum",
        clamp=CLAMP, fresh8=_fresh8(fr) if fresh else None,
        include_d1=include_d1, qscale=QSCALE)
    ref, _ = grouped_state_from_jax(_np(out_j), rc_j, jt, t)

    msgs_v = _torch(mv, dtype)
    bits = torch.full((t.C, t.Z, B), -1, dtype=torch.int8) if emit else None
    out = qg.vn_pass_grouped_minsum(
        _torch(rc, dtype), llr, msgs_v, t, CLAMP, QSCALE, bits=bits,
        fresh=torch.from_numpy(fr) if fresh else None, include_d1=include_d1)
    assert out is msgs_v
    _assert_msgs(out, ref, True, dtype, 0)
    if not (emit or include_d1):  # skipped degree-1 blocks are untouched
        d1 = t.col_groups[0]
        assert d1.degree == 1
        sl = slice(d1.block_start, d1.block_start + d1.count)
        np.testing.assert_array_equal(_np(out)[sl], _np(_torch(mv, dtype))[sl])
    if emit:
        np.testing.assert_array_equal(bits.numpy(), np.asarray(bits_j))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_grouped_init_minsum_matches_jax(grouped, dtype):
    """int8: quantize(clip(llr)) everywhere; float: the llr, clipped in the
    degree-1 group only."""
    jt, t = grouped["jt"], grouped["t"]
    llr = _torch(_llr(np.random.default_rng(13), (t.C, t.Z, B)) * 3,
                 _llr_dtype(dtype))
    jm, jr = jg.init_messages_qc_grouped(
        jnp.asarray(_np(llr).reshape(-1, B)), jt, JAX_DTYPES[dtype],
        alg="min-sum", clamp=CLAMP, qscale=QSCALE)
    ref, _ = grouped_state_from_jax(_np(jm), _np(jr), jt, t)
    mv, rc = qg.init_messages_qc_grouped(llr, t, TORCH_DTYPES[dtype],
                                         alg="min-sum", clamp=CLAMP,
                                         qscale=QSCALE)
    assert mv.dtype == rc.dtype == TORCH_DTYPES[dtype]
    _assert_msgs(mv, ref, True, dtype, 0)
    lv = _np(llr)
    assert np.abs(lv).max() > CLAMP  # the clip rule is exercised
    if dtype != "int8":  # degree >= 2 groups keep the unclipped llr
        assert np.abs(_np(mv)).max() > CLAMP


@pytest.mark.parametrize("dtype,k", [("int8", 1), ("int8", 4),
                                     ("bfloat16", 4)])
def test_grouped_run_iterations_matches_jax(grouped, dtype, k):
    """A superstep on real frames with refilled lanes (a retired frame's
    state in them), the α table and no offset: hard bits, flags and the
    message state exact."""
    jt, t = grouped["jt"], grouped["t"]
    ms = dict(alg="min-sum", beta=0.0, clamp=CLAMP, alpha=ALPHA,
              qscale=QSCALE)
    init = dict(alg="min-sum", clamp=CLAMP, qscale=QSCALE)
    ldt = _llr_dtype(dtype)
    llr = _torch(grouped["llr2d"], ldt)
    stale = _torch(-2.0 * grouped["llr2d"] + 1.0, ldt)
    fresh = np.array([1, 0, 0, 1, 1, 0, 1, 0], bool)
    jm = jg.init_messages_qc_grouped(jnp.asarray(_np(stale)), jt,
                                     JAX_DTYPES[dtype], **init)
    (jmv, jrc), bits_j, viol_j = jg.run_iterations_qc_grouped(
        jm, jnp.asarray(_np(llr), JAX_DTYPES[ldt]),
        jnp.asarray(grouped["syn2d"]), jt, k,
        fresh=jnp.asarray(fresh.astype(np.int8)), **ms)

    def t3(x, rows):
        return x.view(rows, t.Z, B)

    syn = torch.from_numpy(grouped["syn2d"])
    msgs = qg.init_messages_qc_grouped(t3(stale, t.C), t,
                                       TORCH_DTYPES[dtype], **init)
    (mv, _), bits, viol = qg.run_iterations_qc_grouped(
        msgs, t3(llr, t.C), t3(syn, t.R), t, k,
        fresh=torch.from_numpy(fresh), **ms)
    np.testing.assert_array_equal(bits.numpy().reshape(-1, B),
                                  np.asarray(bits_j))
    np.testing.assert_array_equal(viol.numpy(), np.asarray(viol_j))
    ref, _ = grouped_state_from_jax(_np(jmv), _np(jrc), jt, t)
    _assert_msgs(mv, ref, True, dtype, 0)


# ---- regular family ----------------------------------------------------------

@pytest.mark.parametrize("rule", sorted(RULES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_regular_cn_minsum_matches_jax(regular, dtype, rule):
    jt, t = regular["jt"], regular["t"]
    alpha, beta, bitwise = RULES[rule]
    rng = np.random.default_rng(21)
    mv = _msgs(rng, (t.C, t.d_v, t.Z, B), dtype)
    syn = (rng.random((t.R, t.Z, B)) < 0.5).astype(np.int8)
    ref = jp.cn_pass(_jax(mv, dtype), jnp.asarray(syn), jt, alg="min-sum",
                     beta=beta, alpha=alpha)
    r_c = torch.empty((t.R, t.d_c, t.Z, B), dtype=TORCH_DTYPES[dtype])
    out = qr.cn_pass_regular_minsum(_torch(mv, dtype), torch.from_numpy(syn),
                                    r_c, t, alpha, beta)
    assert out is r_c
    _assert_msgs(out, ref, bitwise, dtype, np.abs(_np(_torch(mv, dtype))).max())


@pytest.mark.parametrize("emit,fresh", [
    (False, False),  # plain iteration
    (True, True),    # emit with refilled lanes (k = 1)
    (False, True),   # first iteration after a refill
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_regular_vn_minsum_matches_jax(regular, dtype, emit, fresh):
    jt, t = regular["jt"], regular["t"]
    rng = np.random.default_rng(22)
    rc = _msgs(rng, (t.R, t.d_c, t.Z, B), dtype)
    llr = _torch(_llr(rng, (t.C, t.Z, B)), dtype)
    fr = rng.random(B) < 0.5
    ref, bits_j = jp.vn_pass(_jax(rc, dtype), jnp.asarray(_np(llr),
                                                          JAX_DTYPES[dtype]),
                             jt, emit_bits=emit, alg="min-sum", clamp=CLAMP,
                             fresh8=_fresh8(fr) if fresh else None)
    msgs_v = torch.empty((t.C, t.d_v, t.Z, B), dtype=TORCH_DTYPES[dtype])
    bits = torch.full((t.C, t.Z, B), -1, dtype=torch.int8) if emit else None
    out = qr.vn_pass_regular_minsum(
        _torch(rc, dtype), llr, msgs_v, t, CLAMP, bits=bits,
        fresh=torch.from_numpy(fr) if fresh else None)
    assert out is msgs_v
    _assert_msgs(out, ref, True, dtype, 0)
    if emit:
        np.testing.assert_array_equal(bits.numpy(), np.asarray(bits_j))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_regular_init_minsum_matches_jax(regular, dtype):
    """The regular family's min-sum init is the unclipped llr."""
    jt, t = regular["jt"], regular["t"]
    llr = _torch(_llr(np.random.default_rng(23), (t.C, t.Z, B)) * 3, dtype)
    jm = jp.init_messages_qc_pallas(jnp.asarray(_np(llr).reshape(-1, B)), jt,
                                    JAX_DTYPES[dtype], alg="min-sum")
    ref, _ = regular_state_from_jax(_np(jm), _np(jm), t)
    mv, rc = qr.init_messages_qc_regular(llr, t, TORCH_DTYPES[dtype],
                                         alg="min-sum", clamp=CLAMP)
    assert rc.shape == (t.R, t.d_c, t.Z, B)
    _assert_msgs(mv, ref, True, dtype, 0)
    assert np.abs(_np(mv)).max() > CLAMP  # not clipped


@pytest.mark.parametrize("k", [1, 4])
def test_regular_run_iterations_matches_jax(regular, k):
    """A bfloat16 superstep with refilled lanes at the default offset
    min-sum: hard bits, flags and the message state exact."""
    jt, t = regular["jt"], regular["t"]
    ms = dict(alg="min-sum", beta=0.5, clamp=CLAMP, alpha=1.0)
    llr = _torch(regular["llr2d"], "bfloat16")
    stale = _torch(-2.0 * regular["llr2d"] + 1.0, "bfloat16")
    fresh = np.array([1, 0, 0, 1, 1, 0, 1, 0], bool)
    jm = jp.init_messages_qc_pallas(jnp.asarray(_np(stale)), jt, jnp.bfloat16,
                                    alg="min-sum")
    jmv, bits_j, viol_j = jp.run_iterations_qc_pallas(
        jm, jnp.asarray(_np(llr), jnp.bfloat16),
        jnp.asarray(regular["syn2d"]), jt, k,
        fresh=jnp.asarray(fresh.astype(np.int8)), **ms)
    syn = torch.from_numpy(regular["syn2d"]).view(t.R, t.Z, B)
    msgs = qr.init_messages_qc_regular(stale.view(t.C, t.Z, B), t,
                                       torch.bfloat16, alg="min-sum")
    (mv, _), bits, viol = qr.run_iterations_qc_regular(
        msgs, llr.view(t.C, t.Z, B), syn, t, k,
        fresh=torch.from_numpy(fresh), **ms)
    np.testing.assert_array_equal(bits.numpy().reshape(-1, B),
                                  np.asarray(bits_j))
    np.testing.assert_array_equal(viol.numpy(), np.asarray(viol_j))
    ref, _ = regular_state_from_jax(_np(jmv), _np(jmv), t)
    _assert_msgs(mv, ref, True, "bfloat16", 0)


# ---- both families -------------------------------------------------------------

@pytest.mark.parametrize("family,dtype", [
    ("grouped", "float32"), ("grouped", "bfloat16"), ("grouped", "int8"),
    ("regular", "float32"), ("regular", "bfloat16"),
])
def test_minsum_burst_prefix_identity(grouped, regular, family, dtype):
    """burst(b) then run(k) equals run(b + k) bit for bit."""
    mod, st = (qg, grouped) if family == "grouped" else (qr, regular)
    t = st["t"]
    init = getattr(mod, f"init_messages_qc_{family}")
    run = getattr(mod, f"run_iterations_qc_{family}")
    burst = getattr(mod, f"burst_iterations_qc_{family}")
    ms = dict(alg="min-sum", beta=0.5, clamp=CLAMP, alpha=ALPHA,
              qscale=QSCALE)
    llr = _torch(st["llr2d"], _llr_dtype(dtype)).view(t.C, t.Z, B)
    syn = torch.from_numpy(st["syn2d"]).view(t.R, t.Z, B)
    m0 = init(llr, t, TORCH_DTYPES[dtype], alg="min-sum", clamp=CLAMP,
              qscale=QSCALE)
    m1 = tuple(x.clone() for x in m0)
    burst(m1, llr, syn, t, 3, **ms)
    m1, bits1, viol1 = run(m1, llr, syn, t, 2, **ms)
    m2 = tuple(x.clone() for x in m0)
    m2, bits2, viol2 = run(m2, llr, syn, t, 5, **ms)
    for a, b in zip(m1, m2):
        np.testing.assert_array_equal(_np(a), _np(b))
    assert torch.equal(bits1, bits2)
    assert torch.equal(viol1, viol2)


def test_minsum_passes_check_dtypes(grouped, regular):
    """int8 runs on the grouped family only; the sum-product passes take no
    int8."""
    t, tr = grouped["t"], regular["t"]
    m8 = torch.zeros((t.nb, t.Z, B), dtype=torch.int8)
    syn = torch.zeros((t.R, t.Z, B), dtype=torch.int8)
    with pytest.raises(ValueError, match="dtype"):
        qg.cn_pass_grouped(m8, syn, m8.clone(), t)
    with pytest.raises(ValueError, match="dtype"):  # int8 wants a bf16 llr
        qg.vn_pass_grouped_minsum(m8, torch.zeros((t.C, t.Z, B)), m8.clone(),
                                  t)
    r8 = torch.zeros((tr.C, tr.d_v, tr.Z, B), dtype=torch.int8)
    with pytest.raises(ValueError, match="dtype"):
        qr.cn_pass_regular_minsum(
            r8, torch.zeros((tr.R, tr.Z, B), dtype=torch.int8),
            torch.zeros((tr.R, tr.d_c, tr.Z, B), dtype=torch.int8), tr)
