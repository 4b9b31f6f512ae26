"""The min-sum check kernels' vector lanes and arithmetic, on the CPU.

The grouped and general min-sum check kernels (csrc/qc_minsum_cn.cu,
csrc/general_minsum.cu, both on csrc/minsum.cuh) give each thread 16 bytes
of lanes where the rows are aligned to them (``_kernels.minsum_vec_lanes``,
``minsum_lanes_per_thread``), read each slot once, store the two outgoing
magnitudes of a lane once and give each slot one of them with its sign set
in the stored representation. Here, without a card:

- the lane table and the choice by shape and alignment;
- the identities that design rests on: every storage conversion is odd
  (store(-v) is store(v) with its sign set), exhaustively over the values
  the check rule can store from every int8, bfloat16 and float8_e5m2
  message, and on a float32 sample with its edge values; and the int8
  integer magnitudes order as their dequantized values do, at every qscale
  the decoder accepts;
- the numpy model of the kernels' arithmetic (``ops/minsum_model.py``,
  the scalar path and the 1-byte vector path's words) against the plain
  passes, bit for bit, on staircase codes whose check
  degrees run 1..32, with ties and zeros of both signs (its agreement with
  the JAX kernels: tests/test_torch_general.py and
  tests/test_torch_qc_minsum.py);
- the sources and C signatures the kernels are built and bound from.

The kernels themselves run on the card (tests/test_torch_cuda.py).
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ldpc_decoder_tpu_torch.codes.compiled import compile_code  # noqa: E402
from ldpc_decoder_tpu_torch.codes.qc import (  # noqa: E402
    QCStructure,
    qc_to_code,
)
from ldpc_decoder_tpu_torch.ops import _kernels  # noqa: E402
from ldpc_decoder_tpu_torch.ops import general as G  # noqa: E402
from ldpc_decoder_tpu_torch.ops import minsum_model as M  # noqa: E402
from ldpc_decoder_tpu_torch.ops import qc_grouped as qg  # noqa: E402
from ldpc_decoder_tpu_torch.ops.qc_decode import (  # noqa: E402
    QCDecodeTables,
    dequantize_msgs,
    quantize_msgs,
    resolve_minsum_alpha,
    signed_f32,
)
from ldpc_decoder_tpu_torch.runtime.params import StaticParams  # noqa: E402

CSRC = Path(__file__).resolve().parents[1] / "ldpc_decoder_tpu_torch" / "csrc"
F32, BF16, I8, FP8 = (torch.float32, torch.bfloat16, torch.int8,
                      torch.float8_e5m2)
# the min-sum check launch's lanes per thread at every degree: (B) ->
# {dtype: V}; 16 bytes where B is a multiple of them, else one lane
MINSUM_LANES = {
    768: {F32: 4, BF16: 8, I8: 16, FP8: 16},
    384: {F32: 4, BF16: 8, I8: 16, FP8: 16},
    256: {F32: 4, BF16: 8, I8: 16, FP8: 16},
    48: {F32: 4, BF16: 8, I8: 16, FP8: 16},
    40: {F32: 4, BF16: 8, I8: 1, FP8: 1},
    37: {F32: 1, BF16: 1, I8: 1, FP8: 1},
}
ALPHAS, BETAS = (1.0, 0.8, 0.75), (0.0, 0.5)
# (alpha, beta): plain normalized min-sum, and a per-degree table with an
# offset (degree 1 and the 17..32 range have their own)
RULES = {"alpha 1": (1.0, 0.0),
         "table and offset": (((1, 0.5), (17, 0.9), (32, 0.625), (0, 0.75)),
                              0.25)}


# ---- the lanes --------------------------------------------------------------

@pytest.mark.parametrize("dtype", [F32, BF16, I8, FP8], ids=str)
@pytest.mark.parametrize("B", sorted(MINSUM_LANES))
def test_minsum_lanes(B, dtype):
    v = MINSUM_LANES[B][dtype]
    x = torch.zeros(4 * B + 1, dtype=dtype)
    for d in (1, 6, 32):
        assert _kernels.minsum_vec_lanes(dtype, d) == 16 // x.element_size()
        assert _kernels.minsum_lanes_per_thread(B, dtype, d) == v, d
        assert _kernels._minsum_lanes(B, d, x[:4 * B], x[B:], None) == v
        # a view at an odd offset: one lane per thread
        assert _kernels._minsum_lanes(B, d, x[1:]) == 1
        assert _kernels._minsum_lanes(B, d, x, x[1:]) == 1


# ---- the identities ---------------------------------------------------------

def _rule(m, alpha, beta):
    """max(α·m − β, 0) on float32 magnitudes, as the plain passes round it
    (``qc_decode.minsum_magnitudes``)."""
    return torch.clamp_min(m * torch.tensor(alpha, dtype=F32)
                           - torch.tensor(beta, dtype=F32), 0.0)


def _negated_store_is_signed(r, dtype, bits):
    """torch's store of −r (the plain passes' ``signed_f32`` with the sign
    bit, then the dtype conversion) is its store of r with the sign set,
    and the model's store of r equals torch's."""
    as_int = {BF16: torch.int16, FP8: torch.uint8}[dtype]
    pos = r.to(dtype).view(as_int).numpy().view(bits)
    neg = signed_f32(r, torch.tensor(-2**31, dtype=torch.int32)).to(
        dtype).view(as_int).numpy().view(bits)
    kind = M.KINDS[dtype]
    np.testing.assert_array_equal(neg, pos | (1 << (8 * pos.itemsize - 1)))
    np.testing.assert_array_equal(M.store(r.numpy(), kind, 4.0), pos)
    np.testing.assert_array_equal(
        M.with_sign(pos, np.ones(pos.shape, np.uint32), kind), neg)


@pytest.mark.parametrize("qscale", [1.0, 2.0, 4.0, 8.0])
def test_int8_store_is_odd(qscale):
    """Every magnitude max(α·|q|/qscale − β, 0) of every int8 q:
    quantizing its negation gives the negated step, in torch and in the
    model."""
    q = torch.arange(-128, 128, dtype=torch.int32).to(I8)
    m = dequantize_msgs(q, qscale).abs()
    for alpha in ALPHAS:
        for beta in BETAS:
            r = _rule(m, alpha, beta)
            pos, neg = quantize_msgs(r, qscale), quantize_msgs(-r, qscale)
            assert torch.equal(neg.int(), -pos.int()), (alpha, beta)
            assert (pos >= 0).all()
            s = M.store(r.numpy(), "int8", qscale)
            np.testing.assert_array_equal(s, pos.numpy())
            np.testing.assert_array_equal(
                M.with_sign(s, np.ones(s.shape, np.uint32), "int8"),
                neg.numpy())


@pytest.mark.parametrize("qscale", [2.0**-121, 1.0, 4.0, 2.0**125])
def test_int8_magnitudes_order_as_their_values(qscale):
    """The scan compares |q|: at every qscale the decoder accepts (the
    extremes included) two int8 magnitudes compare as their dequantized
    float32 values do, so m1, pos and m2 are those of the float scan.
    Every stored step (|q| <= 127) is finite; q = -128, which no store
    makes, dequantizes to inf at 2^-121 and still orders last."""
    q = torch.arange(-128, 128, dtype=torch.int32).to(I8)
    a = np.abs(q.numpy().astype(np.int32))
    f = dequantize_msgs(q, qscale).abs().numpy()
    assert np.isfinite(f[a <= 127]).all()
    np.testing.assert_array_equal(a[:, None] < a[None, :],
                                  f[:, None] < f[None, :])
    np.testing.assert_array_equal(a[:, None] == a[None, :],
                                  f[:, None] == f[None, :])
    kw = dict(message_dtype="int8", algorithm="min-sum")
    StaticParams(minsum_qscale=qscale, **kw)
    for outside in (2.0**-122, 2.0**126):
        with pytest.raises(ValueError, match="power of two"):
            StaticParams(minsum_qscale=outside, **kw)


@pytest.mark.parametrize("dtype", [BF16, FP8], ids=str)
def test_narrow_float_store_is_odd(dtype):
    """Every bfloat16 and float8_e5m2 bit pattern m (NaN aside): the values
    max(α·|m| − β, 0) store with their sign OR-ed in, and their magnitude
    bits order as their values."""
    n_bits = 16 if dtype == BF16 else 8
    bits_t = torch.arange(2**n_bits, dtype=torch.int32)
    bits_t = (bits_t.to(torch.int16) if dtype == BF16
              else bits_t.to(torch.uint8))
    m = bits_t.view(dtype).to(F32)
    keep = ~torch.isnan(m)
    m = m[keep].abs()
    for alpha in ALPHAS:
        for beta in BETAS:
            _negated_store_is_signed(_rule(m, alpha, beta), dtype,
                                     np.uint16 if dtype == BF16 else np.uint8)
    stored = bits_t[keep].numpy().view(np.uint16 if dtype == BF16
                                       else np.uint8)
    mag = M.magnitude(stored, M.KINDS[dtype]).astype(np.int64)
    np.testing.assert_array_equal(np.argsort(mag, kind="stable"),
                                  np.argsort(m.numpy(), kind="stable"))
    np.testing.assert_array_equal(M.widen(mag, M.KINDS[dtype], 4.0),
                                  m.numpy())


def test_float32_store_is_odd():
    """float32: a seeded sample over many scales and the edge values (±0,
    subnormals, the steps around int8's ±127 saturation at qscale 4, the
    largest float): the sign OR-ed into the stored value is the plain
    passes' signed value, and magnitude bits order as values."""
    rng = np.random.default_rng(3)
    edges = np.array([0.0, -0.0, 1e-45, 1e-40, 1.1754942e-38, 1.1754944e-38,
                      31.625, 31.75, 31.875, 32.0, 3.4028235e38],
                     np.float32)
    v = np.concatenate([edges] + [
        (rng.standard_normal(4096) * s).astype(np.float32)
        for s in (1e-30, 1e-3, 1.0, 64.0, 1e30)])
    m = torch.from_numpy(np.abs(v))
    for alpha in ALPHAS:
        for beta in BETAS:
            r = _rule(m, alpha, beta)
            neg = signed_f32(r, torch.tensor(-2**31, dtype=torch.int32))
            got = M.with_sign(M.store(r.numpy(), "float32", 4.0),
                              np.ones(r.shape, np.uint32), "float32")
            np.testing.assert_array_equal(got.view(np.uint32),
                                          neg.numpy().view(np.uint32))
    mag = M.magnitude(v, "float32").astype(np.int64)
    a = np.abs(v)
    np.testing.assert_array_equal(mag[:, None] < mag[None, :],
                                  a[:, None] < a[None, :])


# ---- the model against the plain passes -------------------------------------

def _staircase(D, Z, seed):
    """A D x D base whose row r holds columns 0..r: check and variable
    degrees 1..D, random shifts."""
    rows, cols = np.nonzero(np.tril(np.ones((D, D), np.int8)))
    shifts = np.random.default_rng(seed).integers(0, Z, rows.size)
    return QCStructure(Z=Z, n_base_rows=D, n_base_cols=D,
                       edge_row=rows.astype(np.int32),
                       edge_col=cols.astype(np.int32),
                       edge_shift=shifts.astype(np.int32))


def _msgs(rng, shape, dtype):
    """Messages with ties and zeros of both signs: int8 steps in [-40, 40]
    (and a few at -128 and +-127), floats in quarter steps (rounded to the
    dtype)."""
    if dtype == I8:
        q = rng.integers(-40, 41, shape)
        edge = rng.random(shape) < 0.01
        q[edge] = rng.choice([-128, -127, 127], int(edge.sum()))
        return torch.from_numpy(q.astype(np.int8))
    x = np.round(rng.standard_normal(shape) * 40) / 4
    return torch.from_numpy(x.astype(np.float32)).to(dtype)


def _syn(rng, shape):
    return torch.from_numpy((rng.random(shape) < 0.5).astype(np.int8))


@pytest.mark.parametrize("rule", sorted(RULES))
@pytest.mark.parametrize("dtype", [F32, BF16, I8], ids=str)
def test_model_matches_general_plain(dtype, rule):
    """The general check pass: each bucket's gathered rows through the
    model equal the plain pass's rows bit for bit (degrees 1..32)."""
    alpha, beta = RULES[rule]
    t = G.GeneralTables.from_compiled(
        compile_code(qc_to_code(_staircase(32, 4, 5))), "cpu")
    assert sorted(b.degree for b in t.cn_buckets) == list(range(1, 33))
    rng = np.random.default_rng(7)
    mv = _msgs(rng, (t.n_edges, 8), dtype)
    syn = _syn(rng, (t.n_checks, 8))
    rc = G.cn_pass_general_minsum_plain(mv, syn, torch.empty_like(mv), t,
                                        alpha, beta, 4.0)
    m_c = mv.index_select(0, t.perm_v2c)
    for b in t.cn_buckets:
        m, kind = M.to_bits(G._planes(m_c, b))
        args = (m, G._nodes(syn, b).numpy(), kind,
                resolve_minsum_alpha(alpha, b.degree), beta, 4.0)
        want, _ = M.to_bits(G._planes(rc, b))
        np.testing.assert_array_equal(M.check_rows(*args), want,
                                      err_msg=f"d = {b.degree}")
        if kind == "int8":  # the vector path's words
            np.testing.assert_array_equal(M.check_rows_packed(*args), want,
                                          err_msg=f"d = {b.degree}")


@pytest.mark.parametrize("rule", sorted(RULES))
@pytest.mark.parametrize("dtype", [F32, BF16, I8, FP8], ids=str)
def test_model_matches_grouped_plain(dtype, rule):
    """The grouped check pass: each group's rotated rows through the model
    equal the plain pass's rows bit for bit (degrees 1..32)."""
    alpha, beta = RULES[rule]
    t = qg.GroupedQCTables.from_qc_tables(QCDecodeTables.from_structure(
        _staircase(32, 8, 3), 0, "cpu"))
    assert [g.degree for g in t.row_groups] == list(range(1, 33))
    rng = np.random.default_rng(9)
    B = 8
    mv = _msgs(rng, (t.nb, t.Z, B), dtype)
    syn = _syn(rng, (t.R, t.Z, B))
    rc = qg.cn_pass_minsum_plain(mv, syn, torch.empty_like(mv), t, alpha,
                                 beta, 4.0)
    for g in t.row_groups:
        d, n = g.degree, g.count
        sl = slice(g.block_start, g.block_start + n * d)
        rows = qg._rotated(mv, t.cn_src[sl], t.cn_shift[sl], t.Z)
        m, kind = M.to_bits(rows.view(n, d, t.Z, B).transpose(0, 1))
        args = (m, syn[g.node_start:g.node_start + n].numpy(), kind,
                resolve_minsum_alpha(alpha, d), beta, 4.0)
        want, _ = M.to_bits(rc[sl].view(n, d, t.Z, B).transpose(0, 1))
        np.testing.assert_array_equal(M.check_rows(*args), want,
                                      err_msg=f"d = {d}")
        if kind in ("int8", "float8_e5m2"):  # the vector path's words
            np.testing.assert_array_equal(M.check_rows_packed(*args), want,
                                          err_msg=f"d = {d}")


# ---- the sources ------------------------------------------------------------

def test_minsum_sources_and_signatures():
    """The shared header is hashed into every build key, the two check
    kernels compile in their own sources beside their libraries' others,
    and both C entries take the lanes (before the stream) and export the
    lane table."""
    assert "minsum.cuh" in {Path(h).name for h in _kernels.HEADERS}
    names = {lib: [Path(f).name for f in srcs]
             for lib, srcs in _kernels.SOURCES.items()}
    assert names["qc_minsum"] == ["qc_minsum.cu", "qc_minsum_cn.cu"]
    assert names["general"] == ["general.cu", "general_accurate.cu",
                                "general_minsum.cu", "general_fp8.cu"]
    for src in ("qc_minsum_cn.cu", "general_minsum.cu"):
        text = (CSRC / src).read_text()
        assert '#include "minsum.cuh"' in text, src
        assert re.search(r"int dtype, int lanes,\s+void\* stream\)", text), src
    i = _kernels._i
    for lib, entry, n_args in (("qc_minsum", "ldpc_cn_group_minsum", 17),
                               ("general", "ldpc_cn_general_minsum", 15)):
        sig = _kernels._SIGNATURES[lib]
        assert len(sig[entry]) == n_args
        assert sig[entry][-3:] == [i, i, _kernels._p]  # dtype, lanes, stream
        assert sig["ldpc_minsum_vec_lanes"] == [i, i]
    assert "cn_group_minsum_vec" in _kernels.launch_counts
    assert "cn_general_minsum_vec" in _kernels.launch_counts
