"""The QC kernels' fast φ, on the CPU: its float32 model, constants and
fit, and the grouped and regular kernels' vector-width and φ choices.

``phi_abs_fast_np`` (ops/phi.py) models csrc/sum_product.cuh's
``phi_abs_fast`` operation for operation in float32, with the card's
ex2.approx and lg2.approx taken as correctly rounded. It is held to
float64 within the fast φ's target, PHI_FAST_MAX_REL_ERR (2.5e-6, the
accurate kernel's measured 2.43e-6 rounded up), over chip_smoke phase 3's
sweep. Against the JAX package's φ (XLA:CPU's tanh is up to 1.6e-5 off
float64 near x = 5) it is held to that φ's own distance from float64 plus
the same target. The card's MUFU error is measured by chip_smoke phase 3
and tests/test_torch_cuda.py, not here.
"""

import importlib
import inspect
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from ldpc_decoder_tpu_torch.ops import _kernels  # noqa: E402
from ldpc_decoder_tpu_torch.ops import phi_fit  # noqa: E402

jphi = importlib.import_module("ldpc_decoder_tpu.ops.phi")
tphi = importlib.import_module("ldpc_decoder_tpu_torch.ops.phi")
CSRC = Path(__file__).resolve().parents[1] / "ldpc_decoder_tpu_torch" / "csrc"
SOURCE = CSRC / "sum_product.cuh"
TARGET = tphi.PHI_FAST_MAX_REL_ERR


def _sweep():
    """chip_smoke phase 3's points (runtime/smoke.py)."""
    return np.concatenate([
        np.logspace(-5, np.log10(80.0), 60000),
        np.linspace(4.99, 5.01, 4001),
        [5.0, np.nextafter(np.float32(5), np.float32(0)),
         np.nextafter(np.float32(5), np.float32(9)), 6.0, 12.0, 25.0, 50.0,
         80.0],
    ]).astype(np.float32)


# the sweep's pieces: each branch of the fast φ, its seams and the clamps
SEGMENTS = {
    "small": (0.0, 1.0),
    "mid": (1.0, 5.0),
    "tail": (5.0, 81.0),
    "seam-1": (0.99, 1.01),
    "seam-5": (4.99, 5.01),
}


@pytest.mark.parametrize("segment", sorted(SEGMENTS))
def test_fast_model_matches_float64(segment):
    lo, hi = SEGMENTS[segment]
    x = _sweep()
    x = x[(x >= lo) & (x < hi)]
    if segment.startswith("seam"):  # every float32 of the seam
        x = np.unique(np.concatenate([x, np.arange(
            np.float32(lo).view(np.int32), np.float32(hi).view(np.int32),
            dtype=np.int32).view(np.float32)]))
    got = tphi.phi_abs_fast_np(x).astype(np.float64)
    ref = tphi.phi_abs_np(x)
    rel = np.abs(got - ref) / ref
    assert x.size > 100
    assert rel.max() <= TARGET, (rel.max(), x[rel.argmax()])


def test_fast_model_matches_jax():
    x = _sweep()
    got = tphi.phi_abs_fast_np(x).astype(np.float64)
    ref = tphi.phi_abs_np(x)
    jx = np.asarray(jphi.phi_abs(jnp.asarray(x))).astype(np.float64)
    assert (np.abs(got - jx) <= np.abs(jx - ref) + TARGET * ref).all()


qc_pallas = importlib.import_module("ldpc_decoder_tpu.ops.qc_pallas")


@pytest.mark.parametrize("reference", ["float64", "jax-regular"])
def test_fast_model_at_the_fp8_clamp(reference):
    """The regular family's float8_e5m2 clamp (high = 10) through the fast
    φ: against float64 φ with the same clamp within the target, and
    against the JAX regular kernels' φ (``qc_pallas._phi_abs_f32`` with
    high 10) within that φ's own distance from float64 plus the target
    (XLA:CPU's tanh is 1.3e-5 off float64 near x = 5)."""
    x = _sweep()
    got = tphi.phi_abs_fast_np(x, high=10.0).astype(np.float64)
    ref = tphi.phi_abs_np(x, high=10.0)
    ten = tphi.phi_abs_fast_np(np.float32(10.0), high=10.0)
    assert x.max() > 10 and (got[x >= 10] == ten).all()
    if reference == "float64":
        assert (np.abs(got - ref) / ref).max() <= TARGET
        return
    jx = np.asarray(qc_pallas._phi_abs_f32(
        jnp.asarray(x), 10.0, tphi.PRE_THRESHOLD)).astype(np.float64)
    assert (np.abs(got - jx) <= np.abs(jx - ref) + TARGET * ref).all()


@pytest.mark.parametrize("t", [None, 5.0, 10.0, 20.0])
def test_fast_model_clamps_like_phi_abs(t):
    """The input clamp [pre, 80] for the infinity thresholds' floors, and a
    positive, normal result for every input (so a sign bit OR-ed in stays
    exact)."""
    pre = tphi.pre_from_infinity_threshold(t)
    x = np.concatenate([[0.0, pre / 2, pre, 1e-7, 80.0, 81.0, 1e9],
                        np.float32(pre) * np.arange(1, 50)]).astype(
        np.float32)
    got = tphi.phi_abs_fast_np(x, pre)
    ref = tphi.phi_abs_np(x, pre)
    np.testing.assert_allclose(got, ref, rtol=TARGET, atol=0)
    assert (got >= np.finfo(np.float32).tiny).all()
    assert got.dtype == np.float32


def test_fast_model_tail_is_the_reference_tail():
    """Above 5 the fast φ is 2·e^{-x}, not 2·atanh(e^{-x}) (which differs by
    t²/3 ≈ 1.5e-5 just above 5): the reference's branch."""
    x = np.nextafter(np.float32(5), np.float32(9)) + np.float32(
        1e-3) * np.arange(100, dtype=np.float32)
    tail = 2.0 * np.exp(-x.astype(np.float64))
    got = tphi.phi_abs_fast_np(x)
    np.testing.assert_allclose(got, tail, rtol=TARGET, atol=0)


def _cu_constant(name):
    m = re.search(rf"constexpr float {name} = (-?0x[0-9a-fA-F.]+p[-+]?\d+)f;",
                  SOURCE.read_text())
    assert m, name
    return float.fromhex(m.group(1))


def test_cuda_constants_equal_python_copy():
    for i in range(4):
        assert _cu_constant(f"kPhiS{i}") == tphi.PHI_FAST_SMALL[i]
        assert _cu_constant(f"kPhiM{i}") == tphi.PHI_FAST_MID[i]
    assert _cu_constant("kLog2eHi") == tphi.LOG2E_HI
    assert _cu_constant("kLog2eLo") == tphi.LOG2E_LO
    assert _cu_constant("kLn2") == tphi.LN2_F32
    m = re.search(r"constexpr float kPhiSplit = ([0-9.]+)f;",
                  SOURCE.read_text())
    assert float(m.group(1)) == tphi.PHI_FAST_SPLIT == phi_fit.SPLIT


def test_split_constants_are_float32():
    f32 = np.float32
    for v in (*tphi.PHI_FAST_SMALL, *tphi.PHI_FAST_MID, tphi.LOG2E_HI,
              tphi.LOG2E_LO, tphi.LN2_F32):
        assert float(f32(v)) == v
    assert tphi.LOG2E_HI == float(f32(np.log2(np.e)))
    assert abs(tphi.LOG2E_HI + tphi.LOG2E_LO - np.log2(np.e)) < 1e-15
    assert tphi.LN2_F32 == float(f32(np.log(2.0)))


def test_fit_reproduces_constants():
    small, mid = phi_fit.fit()
    assert small == tphi.PHI_FAST_SMALL
    assert mid == tphi.PHI_FAST_MID


def test_fit_main_prints_the_constants(capsys):
    phi_fit.main()
    out = capsys.readouterr().out
    for v in (*tphi.PHI_FAST_SMALL, *tphi.PHI_FAST_MID):
        assert v.hex() in out


DTYPES = [torch.float32, torch.bfloat16, torch.float8_e5m2]
# lanes per thread of the vector instantiation at p41's degrees
# (check 3, 6, 7; variable 1, 2, 4, 8) and at 16
VEC = {
    torch.float32: {1: 4, 2: 4, 3: 4, 4: 4, 6: 4, 7: 4, 8: 4, 16: 4},
    torch.bfloat16: {1: 8, 2: 8, 3: 8, 4: 8, 6: 8, 7: 8, 8: 8, 16: 4},
    torch.float8_e5m2: {1: 16, 2: 16, 3: 16, 4: 16, 6: 8, 7: 8, 8: 8,
                        16: 4},
}


@pytest.mark.parametrize("dtype", DTYPES)
def test_vec_lanes_table(dtype):
    size = torch.empty((), dtype=dtype).element_size()
    for d in range(1, _kernels.MAX_DEGREES["qc_grouped"] + 1):
        v = _kernels.vec_lanes(dtype, d)
        assert v & (v - 1) == 0 and v * size <= 16 and v * d <= 64
        # the widest such: 16 bytes, or twice the lanes would pass 64
        assert v * size == 16 or 2 * v * d > 64
        if d in VEC[dtype]:
            assert v == VEC[dtype][d], d


@pytest.mark.parametrize("B", [256, 8, 36, 100, 512, 4])
@pytest.mark.parametrize("dtype", DTYPES)
def test_lanes_per_thread(B, dtype):
    for d in (1, 3, 6, 7, 8, 16):
        v = _kernels.vec_lanes(dtype, d)
        got = _kernels.lanes_per_thread(B, dtype, d)
        assert got == (v if B % v == 0 else 1)
    # B = 256 takes the vector everywhere; 36 and 100 only where it has 4
    # lanes (float32, or degree 16); 8 all but float8_e5m2's 16
    if B == 256:
        assert _kernels.lanes_per_thread(B, dtype, 6) > 1
    if B == 36:
        assert _kernels.lanes_per_thread(B, dtype, 6) == (
            4 if dtype == torch.float32 else 1)


def test_lanes_follow_alignment():
    """A tensor whose base is off the vector boundary takes one lane per
    thread; the choice is made before the launch, from the layout."""
    a = torch.zeros(4096, dtype=torch.bfloat16)
    assert _kernels._lanes(256, 6, a[:2048]) == 8
    assert _kernels._lanes(256, 6, a[8:], a) == 8
    assert _kernels._lanes(256, 6, a[1:]) == 1
    assert _kernels._lanes(256, 6, a, None, a[2:]) == 1
    assert _kernels._lanes(36, 6, a) == 1


def _small_grouped():
    from ldpc_decoder_tpu_torch.codes.protographs import p41_code
    from ldpc_decoder_tpu_torch.ops import qc_grouped as qg
    from ldpc_decoder_tpu_torch.ops.qc_decode import QCDecodeTables

    code, s = p41_code(Z=32, m=4, coarse=16, fine_mod=4)
    t = qg.GroupedQCTables.from_qc_tables(QCDecodeTables.from_structure(
        s, code.n_erased_vars, "cpu"))
    rng = np.random.default_rng(3)
    B = 4
    mv = torch.from_numpy(rng.standard_normal((t.nb, t.Z, B)).astype(
        np.float32) * 4)
    llr = torch.from_numpy(rng.standard_normal((t.C, t.Z, B)).astype(
        np.float32) * 3)
    syn = torch.from_numpy((rng.random((t.R, t.Z, B)) < 0.5).astype(np.int8))
    return qg, t, mv, llr, syn


@pytest.mark.parametrize("phi", ["fast", "accurate"])
def test_phi_keyword_on_cpu_is_the_plain_version(phi):
    """On CPU tensors both policies take the one plain version."""
    qg, t, mv, llr, syn = _small_grouped()
    rc = qg.cn_pass_grouped(mv, syn, torch.empty_like(mv), t, _phi=phi)
    assert torch.equal(rc, qg.cn_pass_plain(mv, syn, torch.empty_like(mv), t))
    out = qg.vn_pass_grouped(rc, llr, mv.clone(), t, _phi=phi)
    assert torch.equal(out, qg.vn_pass_plain(rc, llr, mv.clone(), t))


def test_phi_keyword_refuses_unknown_policy():
    qg, t, mv, llr, syn = _small_grouped()
    with pytest.raises(ValueError, match="phi policy"):
        qg.cn_pass_grouped(mv, syn, torch.empty_like(mv), t, _phi="exact")
    with pytest.raises(ValueError, match="phi policy"):
        qg.vn_pass_grouped(mv, llr, mv.clone(), t, _phi="tanh")


def test_no_user_setting_selects_phi():
    """The decoder, its parameters and the CLI reach the fast kernels only:
    no field, flag or environment variable names a φ policy."""
    import dataclasses

    from ldpc_decoder_tpu_torch.runtime.params import (
        DynamicParams,
        StaticParams,
    )

    for cls in (StaticParams, DynamicParams):
        assert not [f.name for f in dataclasses.fields(cls)
                    if "phi" in f.name]
    pkg = Path(tphi.__file__).resolve().parents[1]
    for rel in ("runtime/decoder.py", "runtime/harness.py", "cli.py",
                "ops/qc_decode.py"):
        text = (pkg / rel).read_text()
        assert "_phi" not in text and "accurate" not in text, rel
    assert "environ" not in (pkg / "ops" / "_kernels.py").read_text()
    # the sum-product wrappers of both QC families and of the general
    # path: φ is an internal keyword-only argument whose default is the
    # fast kernel, and their runners never pass it
    from ldpc_decoder_tpu_torch.ops import general as G
    from ldpc_decoder_tpu_torch.ops import qc_grouped as qg
    from ldpc_decoder_tpu_torch.ops import qc_regular as qr

    for fn in (qg.cn_pass_grouped, qg.vn_pass_grouped, qr.cn_pass_regular,
               qr.vn_pass_regular, G.cn_pass_general, G.vn_pass_general):
        p = inspect.signature(fn).parameters["_phi"]
        assert p.kind is p.KEYWORD_ONLY and p.default == "fast", fn
    for fn in (qr._iteration, qr.run_iterations_qc_regular,
               qr.burst_iterations_qc_regular, qg._iteration,
               qg.run_iterations_qc_grouped,
               qg.burst_iterations_qc_grouped, G._iteration,
               G.run_iterations_general, G.burst_iterations_general):
        assert "_phi" not in inspect.getsource(fn), fn


# lanes per thread of the vector instantiation at the regular family's
# degrees 17-32 (d_c = 30 among them): two for every dtype
@pytest.mark.parametrize("dtype", DTYPES)
def test_vec_lanes_regular_degrees(dtype):
    size = torch.empty((), dtype=dtype).element_size()
    assert _kernels.MAX_DEGREES["qc_regular"] == 32
    for d in range(17, 33):
        v = _kernels.vec_lanes(dtype, d)
        assert v == 2 and v * size <= 16 and v * d <= 64 < 2 * v * d, d


# reg36's (d_c, d_v) = (6, 3): the (check, variable) lanes per thread at
# its B = 256 and at B = 8 and the ragged 36 and 100; and d_c = 30
REG36_LANES = {
    torch.float32: {256: (4, 4), 8: (4, 4), 36: (4, 4), 100: (4, 4)},
    torch.bfloat16: {256: (8, 8), 8: (8, 8), 36: (1, 1), 100: (1, 1)},
    torch.float8_e5m2: {256: (8, 16), 8: (8, 1), 36: (1, 1), 100: (1, 1)},
}


@pytest.mark.parametrize("B", [256, 8, 36, 100])
@pytest.mark.parametrize("dtype", DTYPES)
def test_lanes_per_thread_reg36(B, dtype):
    got = tuple(_kernels.lanes_per_thread(B, dtype, d) for d in (6, 3))
    assert got == REG36_LANES[dtype][B]
    assert _kernels.lanes_per_thread(B, dtype, 30) == 2


def test_headers_cover_every_include():
    """Every header a kernel source includes is hashed into the build key
    (``_kernels.HEADERS``), so an edited header rebuilds every library."""
    included = set()
    for src in CSRC.iterdir():
        if src.suffix in (".cu", ".cuh"):
            included |= set(re.findall(r'#include "([^"]+)"',
                                       src.read_text()))
    assert included == {Path(h).name for h in _kernels.HEADERS}
    for name, sources in _kernels.SOURCES.items():
        assert all(Path(f).exists() for f in sources), name
    assert [Path(f).name for f in _kernels.SOURCES["qc_regular"]] == [
        "qc_regular.cu", "qc_regular_accurate.cu", "qc_regular_parity.cu"]


def _small_regular():
    from ldpc_decoder_tpu_torch.codes.qc import make_qc_code
    from ldpc_decoder_tpu_torch.ops import qc_regular as qr
    from ldpc_decoder_tpu_torch.ops.qc_decode import QCDecodeTables

    _, s = make_qc_code(np.ones((3, 6), np.int8), Z=16, seed=3)
    t = qr.QCRegularTables.from_qc_tables(QCDecodeTables.from_structure(
        s, 0, "cpu"))
    rng = np.random.default_rng(4)
    B = 8
    mv = torch.from_numpy(rng.standard_normal((t.C, t.d_v, t.Z, B)).astype(
        np.float32) * 4)
    rc = torch.from_numpy(rng.standard_normal((t.R, t.d_c, t.Z, B)).astype(
        np.float32) * 4)
    llr = torch.from_numpy(rng.standard_normal((t.C, t.Z, B)).astype(
        np.float32) * 3)
    syn = torch.from_numpy((rng.random((t.R, t.Z, B)) < 0.5).astype(np.int8))
    fresh = torch.from_numpy(rng.random(B) < 0.5)
    return qr, t, mv, rc, llr, syn, fresh


@pytest.mark.parametrize("phi", ["fast", "accurate"])
def test_regular_phi_keyword_on_cpu_is_the_plain_version(phi):
    """On CPU tensors both policies take the regular family's one plain
    version, with emit and fresh lanes too."""
    qr, t, mv, rc, llr, syn, fresh = _small_regular()
    got = qr.cn_pass_regular(mv, syn, torch.empty_like(rc), t, _phi=phi)
    assert torch.equal(got, qr.cn_pass_plain(mv, syn, torch.empty_like(rc),
                                             t))
    bk, bp = (torch.empty((t.C, t.Z, mv.shape[-1]), dtype=torch.int8)
              for _ in range(2))
    out = qr.vn_pass_regular(rc, llr, mv.clone(), t, bits=bk, fresh=fresh,
                             _phi=phi)
    want = qr.vn_pass_plain(rc, llr, mv.clone(), t, bits=bp, fresh=fresh)
    assert torch.equal(out, want) and torch.equal(bk, bp)


def test_regular_phi_keyword_refuses_unknown_policy():
    qr, t, mv, rc, llr, syn, _ = _small_regular()
    with pytest.raises(ValueError, match="phi policy"):
        qr.cn_pass_regular(mv, syn, torch.empty_like(rc), t, _phi="exact")
    with pytest.raises(ValueError, match="phi policy"):
        qr.vn_pass_regular(rc, llr, mv.clone(), t, _phi="tanh")
