"""φ rounded to float8_e5m2 by a table of thresholds: the general path's
float8_e5m2 sum-product kernels (csrc/general_e5m2.cuh), on the CPU.

The kernels map the clamped float32 input of φ straight to its e5m2 code:
code = #{j : x < t_j}, t_j where the reference φ (−ln tanh(x/2), 2e^-x
past 5, float64) crosses the midpoint between two adjacent e5m2 values,
rounded up to float32. They read it from a table of buckets of x's float32
bits, one threshold a bucket at most (``ops/phi.py`` ``phi_e5m2_table``,
modelled step for step by ``phi_e5m2_lookup_np``); their plain version is
the same thresholds through ``torch.bucketize`` (``phi_e5m2_codes``,
``phi_e5m2``) in the plain check and variable passes
``cn_pass_general_e5m2_plain`` and ``vn_pass_general_e5m2_plain``. The
kernels themselves run on the card only (tests/test_torch_cuda.py holds
them to these passes bit for bit).

Tolerances: the table's φ equals the float64 reference correctly rounded
to e5m2 everywhere on the sweeps (exact). Against the JAX package (XLA's
φ in float32, then ``astype(float8_e5m2)``; XLA:CPU's tanh is off by up
to 1.74e-5 near x = 5): signs, signed zeros and hard bits exact, at most
one e5m2 step on a share of at most FAST_ULP_SHARE (1e-3), the share
printed.
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from ldpc_decoder_tpu.codes.compiled import compile_code as jcompile  # noqa: E402
from ldpc_decoder_tpu.codes.generate import (  # noqa: E402
    make_irregular_code as jmake_irregular,
)
from ldpc_decoder_tpu.ops import decode as D  # noqa: E402
from ldpc_decoder_tpu.ops.phi import phi_abs as jphi_abs  # noqa: E402

from ldpc_decoder_tpu_torch.codes.compiled import compile_code  # noqa: E402
from ldpc_decoder_tpu_torch.codes.generate import (  # noqa: E402
    make_irregular_code,
)
from ldpc_decoder_tpu_torch.ops import _kernels  # noqa: E402
from ldpc_decoder_tpu_torch.ops import general as G  # noqa: E402
from ldpc_decoder_tpu_torch.ops import phi as P  # noqa: E402
from ldpc_decoder_tpu_torch.runtime.perf import (  # noqa: E402
    FAST_ULP_SHARE,
    compare_msgs_fast,
)

FP8 = torch.float8_e5m2
F32 = np.float32
FLT_MIN = np.finfo(F32).tiny
CSRC = Path(__file__).resolve().parents[1] / "ldpc_decoder_tpu_torch" / "csrc"
SWEEP = 1 << 20
# the codes of φ(80) (a signed zero) and φ(FLT_MIN) = 88.03 (96)
FIRST_CODE, LAST_CODE = 0, 86


def _sweep(lo=1e-5, hi=80.0, n=SWEEP):
    """n float32 points log-spaced over [lo, hi]."""
    return np.exp(np.linspace(np.log(lo), np.log(hi), n)).astype(F32)


def _reference_codes(x) -> np.ndarray:
    """φ_abs of float32 x in float64 (its tail included), correctly rounded
    to e5m2: the number of midpoints between adjacent e5m2 values below it
    (no φ of a float32 lies on a midpoint)."""
    vals = P._e5m2_values()
    mids = 0.5 * (vals[:-1] + vals[1:])
    ref = P.phi_abs_np(np.asarray(x, np.float64), pre=0.0)
    return np.searchsorted(mids, ref, side="left")


def _codes(x, pre=P.PRE_THRESHOLD) -> np.ndarray:
    return P.phi_e5m2_codes(torch.from_numpy(np.asarray(x, F32)),
                            pre).numpy()


# ---- the thresholds and the table ------------------------------------------------

def test_thresholds_decrease_and_round_up():
    """Strictly decreasing; each float32 entry the least float32 at or
    above its float64 threshold, so x < t32 exactly when x < t64 for every
    float32 x; each float64 threshold the least float64 whose φ is at most
    its midpoint."""
    t64, t32 = P.phi_e5m2_thresholds()
    assert len(t64) == len(t32) == LAST_CODE
    assert (np.diff(t64) < 0).all() and (np.diff(t32) < 0).all()
    assert (t32.astype(np.float64) >= t64).all()
    below = np.nextafter(t32, F32(-np.inf))
    assert (below.astype(np.float64) < t64).all()
    vals = P._e5m2_values()
    mids = 0.5 * (vals[:-1] + vals[1:])
    for j, t in enumerate(t64):
        assert P._phi_abs_f64(t) <= mids[j] < P._phi_abs_f64(
            np.nextafter(t, -np.inf))


def test_every_code_is_reachable():
    """Every code from φ(80)'s to φ(FLT_MIN)'s is the code of some float32
    in [FLT_MIN, 80]: code(t32[c]) = c and just below it c + 1, through
    the plain lookup and the kernels' model."""
    t32 = P.phi_e5m2_thresholds()[1]
    at = t32
    below = np.nextafter(t32, F32(-np.inf))
    x = np.concatenate([at, below, [F32(FLT_MIN), F32(80.0)]])
    want = np.concatenate([np.arange(LAST_CODE), np.arange(1, LAST_CODE + 1),
                           [LAST_CODE, FIRST_CODE]])
    for got in (_codes(x, pre=0.0), P.phi_e5m2_lookup_np(x, pre=0.0)):
        np.testing.assert_array_equal(got, want)
    assert set(_codes(_sweep(FLT_MIN, 80.0), pre=0.0)) == set(
        range(FIRST_CODE, LAST_CODE + 1))


def test_table_layout_matches_the_header():
    """The bucket count and the clamp of csrc/general_e5m2.cuh equal the
    Python table's (the library checks the same at load, with its bucket
    function against phi_e5m2_bucket_np)."""
    text = (CSRC / "general_e5m2.cuh").read_text()
    n = int(re.search(r"kE5m2Buckets = (\d+);", text).group(1))
    zero = float.fromhex(re.search(r"kE5m2Zero = (\S+)f;", text).group(1))
    shift = int(re.search(r"kE5m2FineShift = (\d+);", text).group(1))
    offset = re.search(r"kE5m2CoarseOffset = (\d+)u \* (\d+)u;", text)
    assert n == len(P.phi_e5m2_table())
    assert zero == P.phi_e5m2_zero() == float(P.phi_e5m2_thresholds()[1][0])
    assert shift == P.E5M2_FINE_SHIFT
    assert int(offset.group(1)) * int(offset.group(2)) == \
        P.E5M2_COARSE_OFFSET
    assert int(offset.group(2)) == P.E5M2_FINE_EXP
    first, last = P.phi_e5m2_bucket_bounds()
    assert P.phi_e5m2_bucket_np(first[0]) == 0
    assert P.phi_e5m2_bucket_np(last[-1]) == n - 1
    assert (first[1:] == last[:-1] + 1).all()  # buckets tile the range


def test_table_holds_one_threshold_a_bucket():
    """The kernels' lookup gives the code on the first and last float32 of
    every bucket; a word's low byte is the code of its bucket's largest x,
    and where the bucket's threshold lies in its binade, the rest is the
    threshold's bits shifted left by 8."""
    table = P.phi_e5m2_table()
    t32 = P.phi_e5m2_thresholds()[1]
    first, last = P.phi_e5m2_bucket_bounds()
    for b in (first, last):
        x = b.astype(np.uint32).view(F32)
        np.testing.assert_array_equal(P.phi_e5m2_lookup_np(x, pre=0.0),
                                      _codes(x, pre=0.0))
    c = (table & 0xFF).astype(np.int64)
    np.testing.assert_array_equal(
        c, _codes(last.astype(np.uint32).view(F32), pre=0.0))
    assert table.dtype == np.uint32 and table.shape == (len(first),)
    thr = t32[np.minimum(c, len(t32) - 1)].view(np.uint32).astype(np.int64)
    inside = (c < len(t32)) & (thr >> 23 == first >> 23)
    assert inside.sum() >= len(t32) - 1  # every threshold but t_85's
    np.testing.assert_array_equal(table[inside] >> 8,
                                  (thr[inside] & 0xFFFFFF))


@pytest.mark.parametrize("pre", [P.PRE_THRESHOLD, 1e-30, 0.0])
def test_kernel_model_equals_bucketize(pre):
    """The kernels' lookup (clamp, bucket, one compare) against the plain
    bucketize on a dense sweep of [FLT_MIN, 80], one ulp either side of
    every threshold and of every bucket edge, x = 0, values past the clamp
    and NaN (which takes the floor, as fmaxf does)."""
    t32 = P.phi_e5m2_thresholds()[1]
    first, last = P.phi_e5m2_bucket_bounds()
    edges = np.concatenate([first, last]).astype(np.uint32).view(F32)
    x = np.concatenate([
        _sweep(FLT_MIN, 80.0), t32, np.nextafter(t32, F32(-np.inf)),
        np.nextafter(t32, F32(np.inf)), edges,
        np.nextafter(edges, F32(-np.inf)), np.nextafter(edges, F32(np.inf)),
        [0.0, 2.0 ** -130, 12.5, 80.0, 81.0, 1e30, np.inf, np.nan]]).astype(
            F32)
    got = P.phi_e5m2_lookup_np(x, pre)
    np.testing.assert_array_equal(got, _codes(x, pre))
    floor = max(F32(pre), F32(FLT_MIN))
    assert got[-1] == _codes([floor], pre)[0]  # NaN
    assert got[-2] == got[-3] == FIRST_CODE


# ---- φ against the references ------------------------------------------------------

def test_plain_equals_float64_reference_rounded():
    """φ by the table equals the float64 reference with its tail, correctly
    rounded to e5m2, on 2^20 float32 points log-spaced over [1e-5, 80]."""
    x = _sweep()
    np.testing.assert_array_equal(_codes(x), _reference_codes(x))


def test_plain_against_jax_phi():
    """Against the JAX package's ``phi_abs(x).astype(float8_e5m2)`` on the
    same sweep: at most one e5m2 step, on a share of at most 1e-3 (the
    differences sit where XLA's float32 φ rounds across a midpoint)."""
    x = _sweep()
    ref = np.asarray(jphi_abs(jnp.asarray(x)).astype(
        jnp.float8_e5m2)).view(np.uint8).astype(np.int32)
    got = _codes(x).astype(np.int32)
    steps = np.abs(got - ref)
    share = float((steps != 0).mean())
    print(f"table phi vs JAX phi: {share:.3e} of {x.size} differ, at x in "
          f"{x[steps != 0][:8]}")
    assert steps.max() <= 1 and share <= FAST_ULP_SHARE


def test_signed_phi_keeps_signs_and_zeros():
    """``phi_e5m2`` carries the input's sign bit, ±0 included (φ of a large
    input rounds to a signed zero)."""
    x = torch.tensor([0.5, -0.5, 20.0, -20.0, 0.0, -0.0, 1e-9, -1e-9])
    got = P.phi_e5m2(x).view(torch.uint8).numpy()
    assert list(got >> 7) == [0, 1, 0, 1, 0, 1, 0, 1]
    assert got[2] == 0x00 and got[3] == 0x80
    np.testing.assert_array_equal(got & 0x7F, _codes(x.abs().numpy()))


@pytest.mark.parametrize("rounding", ["inf", "saturating"])
def test_total_rounding_leaves_the_bytes(rounding):
    """The variable kernels round the total with the card's saturating pair
    conversion (±57344 from 61440 up, where torch gives ±inf); tq − r_k
    then lies past the clamp either way for every |r_k| <= 96 (every φ
    output), so each message byte equals the plain version's, NaN totals
    included (a NaN takes the floor's code, its sign the NaN's)."""
    vals = torch.arange(0x7C, dtype=torch.uint8).view(FP8).float()
    r = torch.cat([vals[vals <= 96], -vals[vals <= 96]])
    tot = torch.tensor([0.0, -0.0, 1.0, -3.5, 57343.0, 57344.0, 61439.0,
                        61440.0, 65535.0, 1e5, 3e38, np.inf, -57344.0,
                        -61440.0, -1e5, -np.inf, np.nan], dtype=torch.float32)
    tq_torch = tot.to(FP8).float()
    tq = (tq_torch if rounding == "inf"
          else tot.clamp(-57344.0, 57344.0).to(FP8).float())
    p = tq[:, None] - r[None, :]
    want = P.phi_e5m2(tq_torch[:, None] - r[None, :]).view(torch.uint8)
    got = P.phi_e5m2(p).view(torch.uint8)
    assert torch.equal(got, want)
    big = tot.abs() >= 61440
    assert (got[big] & 0x7F == 0).all()


# ---- the plain passes ----------------------------------------------------------------

B = 16
# test_torch_general_fp8.py's code: variable degrees 1-12, checks 1, 4-12
IRREGULAR = ((240, 151, {1: 0.05, 2: 0.25, 3: 0.25, 4: 0.15, 6: 0.1,
                         8: 0.1, 12: 0.1},
              {1: 0.05, 4: 0.15, 6: 0.3, 8: 0.25, 10: 0.15, 12: 0.1}),
             dict(seed=1))


@pytest.fixture(scope="module")
def code():
    args, kw = IRREGULAR
    jcc = jcompile(jmake_irregular(*args, **kw))
    cc = compile_code(make_irregular_code(*args, **kw))
    t = G.GeneralTables.from_compiled(cc, "cpu")
    return dict(jt=D.DecodeTables.from_compiled(jcc), t=t,
                cedge=torch.from_numpy(G._edge_map(cc.cn_buckets,
                                                   t.n_edges)))


def _state(t, seed, scale=4.0):
    rng = np.random.default_rng(seed)

    def fp8(shape, s):
        return torch.from_numpy((rng.standard_normal(shape) * s).astype(
            F32)).to(FP8)

    return dict(
        msgs_v=fp8((t.n_edges, B), scale), r_c=fp8((t.n_edges, B), scale),
        llr=torch.from_numpy((rng.standard_normal((t.n_vars, B)) * 3).astype(
            F32)).to(torch.bfloat16),
        syn=torch.from_numpy((rng.random((t.n_checks, B)) < 0.5).astype(
            np.int8)))


def _to_jax(x):
    if x.dtype == FP8:
        return jnp.asarray(x.view(torch.uint8).numpy().view(jnp.float8_e5m2))
    if x.dtype == torch.bfloat16:
        return jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(x.numpy())


def _check_order(c, msgs_v):
    return msgs_v.index_select(0, c["t"].perm_v2c).index_select(0,
                                                                c["cedge"])


def _near(name, port_bits, ref_bits):
    """Signs (±0 included) exact, at most one step apart on a share of at
    most FAST_ULP_SHARE; prints the share."""
    p, r = port_bits.astype(np.int32), ref_bits.astype(np.int32)
    np.testing.assert_array_equal(p >> 7, r >> 7)
    steps = np.abs((p & 0x7F) - (r & 0x7F))
    share = float((steps != 0).mean())
    print(f"{name}: {share:.3e} of {p.size} differ by one step")
    assert steps.max() <= 1 and share <= FAST_ULP_SHARE
    return share


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cn_twin_against_xla(code, seed):
    """The twin check pass against ``cn_update`` (the JAX package's XLA
    path for float8_e5m2 without QC structure)."""
    t, st = code["t"], _state(code["t"], seed)
    ref = D.cn_update(_to_jax(_check_order(code, st["msgs_v"])),
                      _to_jax(st["syn"]), code["jt"])
    out = G.cn_pass_general_e5m2_plain(st["msgs_v"], st["syn"],
                                       torch.empty_like(st["r_c"]), t)
    _near("check twin vs XLA", out.index_select(0, code["cedge"]).view(
        torch.uint8).numpy(), np.asarray(ref).view(np.uint8))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_vn_twin_against_bp_iteration(code, seed):
    """The twin variable pass against ``bp_iteration``'s, fed the same check
    messages: its messages in check order, and hard bits exact."""
    t, jt, st = code["t"], code["jt"], _state(code["t"], seed)
    mc = _to_jax(_check_order(code, st["msgs_v"]))
    syn, llr = _to_jax(st["syn"]), _to_jax(st["llr"])
    r_j = D.cn_update(mc, syn, jt)
    new_j, totals = D.bp_iteration(mc, llr, syn, jt)
    r_c = torch.empty_like(st["r_c"])
    r_c.view(torch.uint8)[code["cedge"]] = torch.from_numpy(
        np.asarray(r_j).view(np.uint8).copy())
    bits = torch.full((t.n_vars, B), -1, dtype=torch.int8)
    out = G.vn_pass_general_e5m2_plain(r_c, st["llr"],
                                       torch.empty_like(st["msgs_v"]), t,
                                       bits=bits)
    _near("variable twin vs XLA",
          _check_order(code, out).view(torch.uint8).numpy(),
          np.asarray(new_j).view(np.uint8))
    np.testing.assert_array_equal(bits.numpy(),
                                  np.asarray(D.hard_bits(totals)))


def test_twins_keep_signed_zeros(code):
    """Large check inputs give ±0 check messages and large variable totals
    ±0 variable messages, with the JAX ops' signs, bit for bit."""
    t, jt = code["t"], code["jt"]
    rng = np.random.default_rng(5)
    sign = np.where(rng.random((t.n_edges, B)) < 0.5, -1.0, 1.0)
    big = torch.from_numpy((sign * rng.uniform(20, 57344, (t.n_edges, B))
                            ).astype(F32)).to(FP8)
    syn = torch.from_numpy((rng.random((t.n_checks, B)) < 0.5).astype(
        np.int8))
    out = G.cn_pass_general_e5m2_plain(big, syn, torch.empty_like(big), t)
    ref = D.cn_update(_to_jax(_check_order(code, big)), _to_jax(syn), jt)
    got = out.index_select(0, code["cedge"]).view(torch.uint8).numpy()
    np.testing.assert_array_equal(got, np.asarray(ref).view(np.uint8))
    assert (got == 0x80).any() and (got == 0x00).any()


@pytest.mark.parametrize("emit", [False, True])
def test_twins_against_the_accurate_plain(code, emit):
    """The twins against the plain passes the CPU decode runs (float32 φ
    through torch's tanh and log, then the store): by the fast rule
    (``compare_msgs_fast``: signs exact, one step on a share <= 1e-3),
    the hard bits equal."""
    t, st = code["t"], _state(code["t"], 7, scale=6.0)
    rk = G.cn_pass_general_e5m2_plain(st["msgs_v"], st["syn"],
                                      torch.empty_like(st["r_c"]), t)
    rp = G.cn_pass_general_plain(st["msgs_v"], st["syn"],
                                 torch.empty_like(st["r_c"]), t)
    compare_msgs_fast("check twin vs accurate plain", rk, rp)
    bk = torch.full((t.n_vars, B), -1, dtype=torch.int8)
    bp = bk.clone()
    mk = G.vn_pass_general_e5m2_plain(st["r_c"], st["llr"],
                                      torch.empty_like(st["msgs_v"]), t,
                                      bits=bk if emit else None)
    mp = G.vn_pass_general_plain(st["r_c"], st["llr"],
                                 torch.empty_like(st["msgs_v"]), t,
                                 bits=bp if emit else None)
    compare_msgs_fast("variable twin vs accurate plain", mk, mp)
    assert torch.equal(bk, bp)


@pytest.mark.parametrize("pre", [P.PRE_THRESHOLD, 1e-30])
def test_twins_equal_the_kernel_model(code, pre):
    """The twins' bytes from the kernels' lookup model: each check
    message's code is phi_e5m2_lookup_np of ext − |m_k| (the twin's float32
    input), so the bucketize twin and the table the kernels read agree on
    the passes' own inputs."""
    t, st = code["t"], _state(code["t"], 8, scale=8.0)
    m_c = st["msgs_v"].index_select(0, t.perm_v2c)
    out = G.cn_pass_general_e5m2_plain(st["msgs_v"], st["syn"],
                                       torch.empty_like(st["r_c"]), t, pre)
    for b in t.cn_buckets:
        m = G._planes(m_c, b).float()
        ext = m[0].abs()
        for k in range(1, b.degree):
            ext = ext + m[k].abs()
        for k in range(b.degree):
            x = (ext - m[k].abs()).numpy()
            got = G._planes(out, b)[k].view(torch.uint8).numpy() & 0x7F
            np.testing.assert_array_equal(got, P.phi_e5m2_lookup_np(x, pre))


def test_cpu_decode_keeps_the_accurate_plain(code):
    """On CPU tensors ``cn_pass_general``/``vn_pass_general`` keep running
    the plain passes the CPU decode is held to JAX with, on float8_e5m2
    too (the twins are reached by name only)."""
    t, st = code["t"], _state(code["t"], 9)
    got = G.cn_pass_general(st["msgs_v"], st["syn"],
                            torch.empty_like(st["r_c"]), t)
    want = G.cn_pass_general_plain(st["msgs_v"], st["syn"],
                                   torch.empty_like(st["r_c"]), t)
    assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))
    got = G.vn_pass_general(st["r_c"], st["llr"],
                            torch.empty_like(st["msgs_v"]), t)
    want = G.vn_pass_general_plain(st["r_c"], st["llr"],
                                   torch.empty_like(st["msgs_v"]), t)
    assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))


def test_twins_refuse_other_dtypes(code):
    t, st = code["t"], _state(code["t"], 10)
    mv = st["msgs_v"].float()
    with pytest.raises((TypeError, ValueError)):
        G.cn_pass_general_e5m2_plain(mv, st["syn"], torch.empty_like(mv), t)
    with pytest.raises((TypeError, ValueError)):
        G.vn_pass_general_e5m2_plain(mv, st["llr"], torch.empty_like(mv), t)


def test_library_entries_and_device_table():
    """The general library's threshold entries take (pointers, the table,
    node range, degree, edge start, B, pre, lanes, stream); the device
    table is the Python table's bits as int32."""
    sig = _kernels._SIGNATURES["general"]
    assert len(sig["ldpc_cn_general_e5m2"]) == 13
    assert len(sig["ldpc_vn_general_e5m2"]) == 14
    assert "general_e5m2.cuh" in {Path(h).name for h in _kernels.HEADERS}
    tab = _kernels.phi_e5m2_table("cpu")
    assert tab.dtype == torch.int32 and tab.is_contiguous()
    assert tab.shape == (len(P.phi_e5m2_table()),)
    np.testing.assert_array_equal(tab.numpy().view(np.uint32),
                                  P.phi_e5m2_table())
    assert _kernels.phi_e5m2_table("cpu") is tab
    src = (CSRC / "general_fp8.cu").read_text()
    assert '#include "general_e5m2.cuh"' in src
    assert "run_cn<__nv_fp8_e5m2, D, 1, PhiFast>" not in (
        CSRC / "general_minsum.cuh").read_text()
