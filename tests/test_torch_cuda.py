"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU. The
file imports neither JAX nor the JAX package, so it runs on the card's
host, which has no JAX; run it there with the repository's conftest
(which imports JAX) left out:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: signs, hard bits, parity flags and decoded words are exact;
sum-product messages are within one ulp of the storage dtype (the plain
version's φ goes through torch's CUDA tanh/log, the kernel's through
tanhf/logf; float8_e5m2: one e5m2 step on a share of at most 1e-3); the
grouped and regular kernels are held so on their accurate-φ
instantiation, and their fast φ (MUFU and FMA, the decoder's) by
``runtime.perf.compare_msgs_fast`` (float32 within 2 × 2.5e-6 + 2^-22
relative; bf16 one ulp, e5m2 one step, on a share of at most 1e-3), and
so are the general sum-product kernels; on a regular base the two QC
families' kernels give the same bits under either policy (float32,
bfloat16);
min-sum messages (general and QC, f32, bf16, float8_e5m2 and int8) are
bitwise equal, and min-sum decodes equal in per-frame iterations too. The
kernels' float8_e5m2 store equals torch's conversion on the card and on
the CPU for every bfloat16 input.
"""

import functools
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ldpc_decoder_tpu_torch.channels import BIAWGNChannel  # noqa: E402
from ldpc_decoder_tpu_torch.codes.compiled import compile_code  # noqa: E402
from ldpc_decoder_tpu_torch.codes.generate import (  # noqa: E402
    make_irregular_code,
    make_regular_code,
)
from ldpc_decoder_tpu_torch.codes.protographs import p41_code  # noqa: E402
from ldpc_decoder_tpu_torch.codes.qc import (  # noqa: E402
    QCStructure,
    make_qc_code,
)
from ldpc_decoder_tpu_torch.ops import general as G  # noqa: E402
from ldpc_decoder_tpu_torch.ops import qc_grouped as qg  # noqa: E402
from ldpc_decoder_tpu_torch.ops import qc_regular as qr  # noqa: E402
from ldpc_decoder_tpu_torch.ops.qc_decode import QCDecodeTables  # noqa: E402
from ldpc_decoder_tpu_torch.runtime.datagen import create_data  # noqa: E402
from ldpc_decoder_tpu_torch.runtime import perf  # noqa: E402
from ldpc_decoder_tpu_torch.runtime.decoder import LDPCDecoder  # noqa: E402
from ldpc_decoder_tpu_torch.runtime.params import (  # noqa: E402
    DynamicParams,
    StaticParams,
)

SMALL = dict(Z=128, m=4, coarse=64, fine_mod=16)
B = 8


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def small_code():
    return p41_code(**SMALL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_match_plain(small_code, cuda_device, dtype):
    from ldpc_decoder_tpu_torch.ops import _kernels

    code, s = small_code
    t = qg.GroupedQCTables.from_qc_tables(QCDecodeTables.from_structure(
        s, code.n_erased_vars, cuda_device))
    rng = np.random.default_rng(5)

    def rand(shape, scale):
        x = rng.standard_normal(shape).astype(np.float32) * scale
        return torch.from_numpy(x).to(cuda_device, dtype)

    mv, rc = rand((t.nb, t.Z, B), 4), rand((t.nb, t.Z, B), 4)
    llr = rand((t.C, t.Z, B), 3)
    syn = torch.from_numpy((rng.random((t.R, t.Z, B)) < 0.5).astype(
        np.int8)).to(cuda_device)
    fresh = torch.from_numpy(rng.random(B) < 0.5).to(cuda_device)
    ulp = 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -22
    before = dict(_kernels.launch_counts)

    # the accurate-φ instantiation: the plain version's φ (the fast one is
    # held to its own rule in test_grouped_kernels_both_phi)
    rk = qg.cn_pass_grouped(mv, syn, rc.clone(), t, _phi="accurate")
    rp = qg.cn_pass_plain(mv, syn, rc.clone(), t)
    assert torch.equal(torch.signbit(rk), torch.signbit(rp))
    torch.testing.assert_close(rk.float(), rp.float(), rtol=ulp, atol=0)

    for emit, fr, d1 in [(False, None, False), (True, fresh, False),
                         (False, fresh, True)]:
        bk = torch.full((t.C, t.Z, B), -1, dtype=torch.int8,
                        device=cuda_device)
        bp = bk.clone()
        mk = qg.vn_pass_grouped(rc, llr, mv.clone(), t,
                                bits=bk if emit else None, fresh=fr,
                                include_d1=d1, _phi="accurate")
        mp = qg.vn_pass_plain(rc, llr, mv.clone(), t,
                              bits=bp if emit else None, fresh=fr,
                              include_d1=d1)
        assert torch.equal(torch.signbit(mk), torch.signbit(mp))
        torch.testing.assert_close(mk.float(), mp.float(), rtol=ulp, atol=0)
        assert torch.equal(bk, bp)

    bits = torch.from_numpy((rng.random((t.C, t.Z, B)) < 0.5).astype(
        np.int8)).to(cuda_device)
    assert torch.equal(qg.parity_pass_grouped(bits, syn, t),
                       qg.parity_pass_plain(bits, syn, t))
    torch.cuda.synchronize()
    n_rows, n_cols = len(t.row_groups), len(t.col_groups)
    assert _kernels.launch_counts["cn"] - before["cn"] == n_rows
    assert _kernels.launch_counts["parity"] - before["parity"] == n_rows
    # non-emit skips the degree-1 group; emit and include_d1 run it
    assert _kernels.launch_counts["vn"] - before["vn"] == 3 * n_cols - 1


@pytest.mark.cuda
@pytest.mark.parametrize("B", [256, 36])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float8_e5m2])
def test_grouped_kernels_both_phi(cuda_device, dtype, B):
    """Every check and variable degree 1-16 (a staircase base), aligned
    B = 256 (the vector instantiations) and ragged B = 36 (one lane per
    thread, but float32's 4), with and without fresh lanes, emit and
    include_d1: the accurate-φ kernels against the plain passes by today's
    rule, the fast ones by the fast rule, fast against accurate too; hard
    bits exact; launches counted as before, the accurate ones also under
    ``phi_accurate``."""
    from ldpc_decoder_tpu_torch.ops import _kernels
    from ldpc_decoder_tpu_torch.runtime import perf

    t = qg.GroupedQCTables.from_qc_tables(QCDecodeTables.from_structure(
        _staircase_structure(16, 24, 7), 0, cuda_device))
    assert [g.degree for g in t.row_groups] == list(range(1, 17))
    assert [g.degree for g in t.col_groups] == list(range(1, 17))
    assert (_kernels.lanes_per_thread(B, dtype, 6) > 1) == (
        B == 256 or dtype == torch.float32)
    rng = np.random.default_rng(13)

    def rand(shape, scale, dt):
        x = rng.standard_normal(shape).astype(np.float32) * scale
        return torch.from_numpy(x).to(cuda_device, dt)

    mv, rc = rand((t.nb, t.Z, B), 5, dtype), rand((t.nb, t.Z, B), 5, dtype)
    llr = rand((t.C, t.Z, B), 4, G.llr_dtype(dtype))
    syn = torch.from_numpy((rng.random((t.R, t.Z, B)) < 0.5).astype(
        np.int8)).to(cuda_device)
    fresh = torch.from_numpy(rng.random(B) < 0.5).to(cuda_device)
    cn_name, vn_name = ("cn_fp8", "vn_fp8") if dtype == FP8 else ("cn", "vn")
    before = dict(_kernels.launch_counts)
    rp = qg.cn_pass_plain(mv, syn, torch.empty_like(rc), t)
    r = {phi: qg.cn_pass_grouped(mv, syn, torch.empty_like(rc), t, _phi=phi)
         for phi in ("accurate", "fast")}
    perf.compare_msgs("r_c accurate", r["accurate"], rp)
    perf.compare_msgs_fast("r_c fast", r["fast"], rp)
    perf.compare_msgs_fast("r_c fast vs accurate", r["fast"], r["accurate"])
    for emit, fr, d1 in [(False, None, False), (True, fresh, False),
                         (False, fresh, True), (True, None, True)]:
        bp = torch.full((t.C, t.Z, B), -1, dtype=torch.int8,
                        device=cuda_device)
        mp = qg.vn_pass_plain(rc, llr, mv.clone(), t,
                              bits=bp if emit else None, fresh=fr,
                              include_d1=d1)
        m = {}
        for phi in ("accurate", "fast"):
            bk = torch.full_like(bp, -1)
            m[phi] = qg.vn_pass_grouped(rc, llr, mv.clone(), t,
                                        bits=bk if emit else None, fresh=fr,
                                        include_d1=d1, _phi=phi)
            assert torch.equal(bk, bp), (phi, emit, d1)
        perf.compare_msgs("msgs_v accurate", m["accurate"], mp)
        perf.compare_msgs_fast("msgs_v fast", m["fast"], mp)
        perf.compare_msgs_fast("msgs_v fast vs accurate", m["fast"],
                               m["accurate"])
    torch.cuda.synchronize()
    counts = {n: _kernels.launch_counts[n] - before[n]
              for n in (cn_name, vn_name, "phi_accurate")}
    # per policy: 16 check groups; the variable runs skip the degree-1
    # group only in the plain iteration
    assert counts == {cn_name: 2 * 16, vn_name: 2 * (4 * 16 - 1),
                      "phi_accurate": 16 + 4 * 16 - 1}


@pytest.mark.cuda
def test_fast_phi_matches_its_model(cuda_device):
    """The fast φ on the card (through a degree-2 check, as the numerics
    smoke reads it) against its float32 model ops/phi.py phi_abs_fast_np,
    whose ex2/lg2 are correctly rounded: within the MUFU's error."""
    from ldpc_decoder_tpu_torch.ops.phi import (
        PHI_FAST_MAX_REL_ERR,
        phi_abs_fast_np,
        phi_abs_np,
    )
    from ldpc_decoder_tpu_torch.runtime.smoke import _check_phi

    x = np.concatenate([np.geomspace(1e-5, 80.0, 20000),
                        np.linspace(0.99, 1.01, 2001),
                        np.linspace(4.99, 5.01, 2001)]).astype(np.float32)
    got = _check_phi(x, torch.float32, "grouped", cuda_device, "fast")
    got = got.cpu().numpy().astype(np.float64)
    model = phi_abs_fast_np(x).astype(np.float64)
    assert (got > 0).all()
    np.testing.assert_allclose(got, model, rtol=1e-6, atol=0)
    ref = phi_abs_np(x)
    assert (np.abs(got - ref) / ref).max() <= PHI_FAST_MAX_REL_ERR
    sign = _check_phi(-x[:100], torch.float32, "grouped", cuda_device,
                      "fast").cpu()
    assert torch.signbit(sign).all()


@pytest.mark.cuda
def test_decode_on_card_matches_cpu(small_code, cuda_device):
    """The slice on the small code: kernels on the card vs plain passes on
    the CPU, float32 messages; equal words, zero bit errors."""
    code, s = small_code
    ch = BIAWGNChannel(0.7)
    n = 3 * 32 + 8
    batch = create_data(code, ch, 0, n, backend="numpy")
    dyn = DynamicParams(num_iter_max=60, num_iter_check_parity=5)
    out = {}
    for dev in ("cpu", cuda_device):
        dec = LDPCDecoder(code, ch, StaticParams(parallel_factor_user=32),
                          qc=s, device=dev)
        out[str(dev)] = dec.decode(dyn, n, batch.values, batch.syndromes)
    (res_c, st_c), (res_g, st_g) = out["cpu"], out[str(cuda_device)]
    np.testing.assert_array_equal(res_g, res_c)
    assert (res_g == batch.ref_bits_packed()).all()
    assert abs(st_g.avg_iter - st_c.avg_iter) <= 5


def _regular_structure(d_c, Z, seed):
    """A (3, d_c) all-ones base with random shifts: enough for holding the
    kernels to their plain versions (no girth needed)."""
    rows, cols = np.nonzero(np.ones((3, d_c), np.int8))
    shifts = np.random.default_rng(seed).integers(0, Z, rows.size)
    return QCStructure(Z=Z, n_base_rows=3, n_base_cols=d_c,
                       edge_row=rows.astype(np.int32),
                       edge_col=cols.astype(np.int32),
                       edge_shift=shifts.astype(np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("d_c", [6, 30])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_regular_kernels_match_plain(cuda_device, dtype, d_c):
    from ldpc_decoder_tpu_torch.ops import _kernels

    t = qr.QCRegularTables.from_qc_tables(QCDecodeTables.from_structure(
        _regular_structure(d_c, 96, d_c), 0, cuda_device))
    rng = np.random.default_rng(6)

    def rand(shape, scale):
        x = rng.standard_normal(shape).astype(np.float32) * scale
        return torch.from_numpy(x).to(cuda_device, dtype)

    mv = rand((t.C, t.d_v, t.Z, B), 4)
    rc = rand((t.R, t.d_c, t.Z, B), 4)
    llr = rand((t.C, t.Z, B), 3)
    syn = torch.from_numpy((rng.random((t.R, t.Z, B)) < 0.5).astype(
        np.int8)).to(cuda_device)
    fresh = torch.from_numpy(rng.random(B) < 0.5).to(cuda_device)
    ulp = 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -22
    before = dict(_kernels.launch_counts)

    # the accurate-φ instantiation: the plain version's φ (the fast one is
    # held to its own rule in test_regular_kernels_both_phi)
    rk = qr.cn_pass_regular(mv, syn, rc.clone(), t, _phi="accurate")
    rp = qr.cn_pass_plain(mv, syn, rc.clone(), t)
    assert torch.equal(torch.signbit(rk), torch.signbit(rp))
    torch.testing.assert_close(rk.float(), rp.float(), rtol=ulp, atol=0)

    for emit, fr in [(False, None), (True, fresh), (False, fresh)]:
        bk = torch.full((t.C, t.Z, B), -1, dtype=torch.int8,
                        device=cuda_device)
        bp = bk.clone()
        mk = qr.vn_pass_regular(rc, llr, mv.clone(), t,
                                bits=bk if emit else None, fresh=fr,
                                _phi="accurate")
        mp = qr.vn_pass_plain(rc, llr, mv.clone(), t,
                              bits=bp if emit else None, fresh=fr)
        assert torch.equal(torch.signbit(mk), torch.signbit(mp))
        torch.testing.assert_close(mk.float(), mp.float(), rtol=ulp, atol=0)
        assert torch.equal(bk, bp)

    bits = torch.from_numpy((rng.random((t.C, t.Z, B)) < 0.5).astype(
        np.int8)).to(cuda_device)
    assert torch.equal(qr.parity_pass_regular(bits, syn, t),
                       qr.parity_pass_plain(bits, syn, t))
    torch.cuda.synchronize()
    for name, n in (("cn_regular", 1), ("vn_regular", 3),
                    ("parity_regular", 1), ("phi_accurate", 4)):
        assert _kernels.launch_counts[name] - before[name] == n


@pytest.mark.cuda
@pytest.mark.parametrize("B", [256, 36])
@pytest.mark.parametrize("d_c", [6, 16, 30])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float8_e5m2])
def test_regular_kernels_both_phi(cuda_device, dtype, d_c, B):
    """The regular sum-product kernels at d_c = 6, 16 and 30 (d_v = 3),
    aligned B = 256 (the vector instantiations) and ragged B = 36 (one
    lane per thread where the vector holds 8 or 16), with and without
    fresh lanes and emit: the accurate-φ kernels against the plain passes
    by today's rule, the fast ones by the fast rule, fast against accurate
    too; hard bits exact. Where the grouped family takes the same base
    (d_c <= 16) and clamp (not float8_e5m2), each output equals the
    grouped kernel's under the same policy, bit for bit. Launches counted,
    the accurate ones also under ``phi_accurate``."""
    from ldpc_decoder_tpu_torch.ops import _kernels
    from ldpc_decoder_tpu_torch.runtime import perf

    qct = QCDecodeTables.from_structure(_regular_structure(d_c, 48, d_c + 1),
                                        0, cuda_device)
    t = qr.QCRegularTables.from_qc_tables(qct)
    twin = d_c <= 16 and dtype != FP8
    tg = qg.GroupedQCTables.from_qc_tables(qct) if twin else None
    # B = 36 takes one lane per thread only where the vector has 8 or 16
    ragged = B == 36 and d_c == 6 and dtype != torch.float32
    assert _kernels.lanes_per_thread(B, dtype, d_c) == (
        1 if ragged else _kernels.vec_lanes(dtype, d_c))
    rng = np.random.default_rng(17)

    def rand(shape, scale, dt):
        x = rng.standard_normal(shape).astype(np.float32) * scale
        return torch.from_numpy(x).to(cuda_device, dt)

    mv = rand((t.C, t.d_v, t.Z, B), 5, dtype)
    rc = rand((t.R, t.d_c, t.Z, B), 5, dtype)
    llr = rand((t.C, t.Z, B), 4, G.llr_dtype(dtype))
    syn = torch.from_numpy((rng.random((t.R, t.Z, B)) < 0.5).astype(
        np.int8)).to(cuda_device)
    fresh = torch.from_numpy(rng.random(B) < 0.5).to(cuda_device)
    flat = (t.C * t.d_v, t.Z, B)
    cn_name, vn_name = (("cn_regular_fp8", "vn_regular_fp8") if dtype == FP8
                        else ("cn_regular", "vn_regular"))
    before = dict(_kernels.launch_counts)
    rp = qr.cn_pass_plain(mv, syn, torch.empty_like(rc), t)
    r = {phi: qr.cn_pass_regular(mv, syn, torch.empty_like(rc), t, _phi=phi)
         for phi in ("accurate", "fast")}
    perf.compare_msgs("r_c accurate", r["accurate"], rp)
    perf.compare_msgs_fast("r_c fast", r["fast"], rp)
    perf.compare_msgs_fast("r_c fast vs accurate", r["fast"], r["accurate"])
    for phi in r if twin else ():
        rg = qg.cn_pass_grouped(mv.view(flat), syn,
                                torch.empty(flat, dtype=dtype,
                                            device=cuda_device), tg,
                                _phi=phi)
        assert _same_bits(r[phi], rg.view_as(r[phi])), phi
    runs = [(False, None), (True, fresh), (False, fresh), (True, None)]
    for emit, fr in runs:
        bp = torch.full((t.C, t.Z, B), -1, dtype=torch.int8,
                        device=cuda_device)
        mp = qr.vn_pass_plain(rc, llr, mv.clone(), t,
                              bits=bp if emit else None, fresh=fr)
        m = {}
        for phi in ("accurate", "fast"):
            bk = torch.full_like(bp, -1)
            m[phi] = qr.vn_pass_regular(rc, llr, mv.clone(), t,
                                        bits=bk if emit else None, fresh=fr,
                                        _phi=phi)
            assert torch.equal(bk, bp), (phi, emit)
            if twin:
                bg = torch.full_like(bp, -1)
                mg = qg.vn_pass_grouped(rc.view(t.R * t.d_c, t.Z, B), llr,
                                        mv.clone().view(flat), tg,
                                        bits=bg if emit else None, fresh=fr,
                                        _phi=phi)
                assert _same_bits(m[phi], mg.view_as(m[phi])), (phi, emit)
                assert torch.equal(bg, bk), (phi, emit)
        perf.compare_msgs("msgs_v accurate", m["accurate"], mp)
        perf.compare_msgs_fast("msgs_v fast", m["fast"], mp)
        perf.compare_msgs_fast("msgs_v fast vs accurate", m["fast"],
                               m["accurate"])
    torch.cuda.synchronize()
    counts = {n: _kernels.launch_counts[n] - before[n]
              for n in (cn_name, vn_name, "phi_accurate", "cn", "vn")}
    # per policy one check launch and one variable launch per run; the
    # grouped twin has one degree group on each side
    n_twin = int(twin)
    assert counts == {cn_name: 2, vn_name: 2 * len(runs),
                      "phi_accurate": (1 + len(runs)) * (1 + n_twin),
                      "cn": 2 * n_twin, "vn": 2 * len(runs) * n_twin}


@pytest.mark.cuda
def test_regular_decode_on_card_matches_cpu(cuda_device):
    """The regular family on a small (3,6) code: kernels on the card vs
    plain passes on the CPU, float32 messages; equal words."""
    code, s = make_qc_code(np.ones((3, 6), np.int8), Z=128, seed=1)
    ch = BIAWGNChannel(0.7)
    n = 3 * 32 + 8
    batch = create_data(code, ch, 0, n, backend="numpy")
    dyn = DynamicParams(num_iter_max=60, num_iter_check_parity=5)
    out = {}
    for dev in ("cpu", cuda_device):
        dec = LDPCDecoder(code, ch, StaticParams(parallel_factor_user=32),
                          qc=s, device=dev)
        assert isinstance(dec.tables, qr.QCRegularTables)
        out[str(dev)] = dec.decode(dyn, n, batch.values, batch.syndromes)
    (res_c, st_c), (res_g, st_g) = out["cpu"], out[str(cuda_device)]
    np.testing.assert_array_equal(res_g, res_c)
    assert (res_g == batch.ref_bits_packed()).all()
    assert abs(st_g.avg_iter - st_c.avg_iter) <= 5


# a multi-bucket code with degree-1 variables and degree-1 checks (540
# edges on each side, so no degree is nudged)
IRREGULAR = ((200, 100, {1: 0.1, 2: 0.3, 3: 0.4, 4: 0.2},
              {1: 0.1, 5: 0.1, 6: 0.8}), dict(seed=5))
B_GENERAL = 40  # not a multiple of 32: the last lane chunk is partial


def _general_state(device, dtype, seed, nb=B_GENERAL):
    t = G.GeneralTables.from_compiled(compile_code(
        make_irregular_code(*IRREGULAR[0], **IRREGULAR[1])), device)
    rng = np.random.default_rng(seed)

    def rand(rows, scale, dt):
        x = rng.standard_normal((rows, nb)).astype(np.float32) * scale
        if dt == torch.int8:
            x = np.clip(np.round(x * 2.5), -127, 127).astype(np.int8)
            return torch.from_numpy(x).to(device)
        return torch.from_numpy(x).to(device, dt)

    return t, dict(
        mv=rand(t.n_edges, 4, dtype), rc=rand(t.n_edges, 4, dtype),
        llr=rand(t.n_vars, 12, G.llr_dtype(dtype)),
        syn=torch.from_numpy((rng.random((t.n_checks, nb)) < 0.5).astype(
            np.int8)).to(device))


def _same_bits(a, b):
    as_int = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
              torch.int8: torch.int8, torch.float8_e5m2: torch.uint8}[a.dtype]
    return torch.equal(a.view(as_int), b.view(as_int))


@pytest.mark.cuda
@pytest.mark.parametrize("B", [B_GENERAL, 37])
@pytest.mark.parametrize("phi", ["accurate", "fast"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_general_kernels_match_plain(cuda_device, dtype, phi, B):
    """The general sum-product kernels of each φ policy, at B = 40 (the
    vector instantiations at every degree) and the ragged B = 37 (one lane
    per thread), with and without emit: the accurate-φ kernels against the
    plain passes by today's rule (signs exact, one ulp of the storage
    dtype), the fast ones by the fast rule, against plain and against the
    accurate kernels; hard bits exact. Launches counted, the accurate ones
    also under ``phi_accurate``."""
    from ldpc_decoder_tpu_torch.ops import _kernels
    from ldpc_decoder_tpu_torch.runtime import perf

    t, st = _general_state(cuda_device, dtype, 7, B)
    for b in t.cn_buckets + t.vn_buckets:
        assert _kernels.lanes_per_thread(B, dtype, b.degree) == (
            1 if B == 37 else _kernels.vec_lanes(dtype, b.degree))
    ulp = 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -22

    def held(k, p):
        if phi == "accurate":
            assert torch.equal(torch.signbit(k), torch.signbit(p))
            torch.testing.assert_close(k.float(), p.float(), rtol=ulp, atol=0)
        else:
            perf.compare_msgs_fast("general fast", k, p)

    def vn(impl, bits, **kw):
        return impl(st["rc"], st["llr"], torch.empty_like(st["mv"]), t,
                    bits=bits, **kw)

    before = dict(_kernels.launch_counts)
    rk = G.cn_pass_general(st["mv"], st["syn"], torch.empty_like(st["rc"]), t,
                           _phi=phi)
    rp = G.cn_pass_general_plain(st["mv"], st["syn"],
                                 torch.empty_like(st["rc"]), t)
    held(rk, rp)
    mk = {}
    for emit in (False, True):
        bk = torch.full((t.n_vars, B), -1, dtype=torch.int8,
                        device=cuda_device)
        bp = bk.clone()
        mk[emit] = vn(G.vn_pass_general, bk if emit else None, _phi=phi)
        held(mk[emit], vn(G.vn_pass_general_plain, bp if emit else None))
        assert torch.equal(bk, bp)
    torch.cuda.synchronize()
    counts = {n: _kernels.launch_counts[n] - before[n]
              for n in ("cn_general", "vn_general", "phi_accurate")}
    passes = len(t.cn_buckets) + 2 * len(t.vn_buckets)
    assert counts == {"cn_general": len(t.cn_buckets),
                      "vn_general": 2 * len(t.vn_buckets),
                      "phi_accurate": passes if phi == "accurate" else 0}
    if phi == "fast":
        ra = G.cn_pass_general(st["mv"], st["syn"],
                               torch.empty_like(st["rc"]), t,
                               _phi="accurate")
        perf.compare_msgs_fast("general fast vs accurate", rk, ra)
        for emit in (False, True):
            bk = torch.full((t.n_vars, B), -1, dtype=torch.int8,
                            device=cuda_device)
            ma = vn(G.vn_pass_general, bk if emit else None, _phi="accurate")
            perf.compare_msgs_fast("general fast vs accurate", mk[emit], ma)


# min-sum check kernel layouts: (B, tensors at an odd offset); B = 64 takes
# the vector instantiation in every dtype, 40 in float32 and bfloat16 only,
# the ragged 37 and the offset views one lane per thread
MINSUM_LAYOUTS = {"64": (64, False), "40": (40, False), "37": (37, False),
                  "64 at an odd offset": (64, True)}


def _at_odd_offset(x):
    """A copy of ``x`` whose base is one element past an aligned one."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    buf[1:].copy_(x.reshape(-1))
    return buf[1:].view(x.shape)


def _minsum_vector(layout, dtype):
    """Whether a min-sum check launch in ``layout`` takes the vector
    instantiation (the lanes of _kernels.minsum_lanes_per_thread)."""
    from ldpc_decoder_tpu_torch.ops import _kernels

    B, offset = MINSUM_LAYOUTS[layout]
    return not offset and _kernels.minsum_lanes_per_thread(B, dtype, 6) > 1


@pytest.mark.cuda
@pytest.mark.parametrize("layout", sorted(MINSUM_LAYOUTS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_general_minsum_kernels_match_plain(cuda_device, dtype, layout):
    """Bitwise, with a per-degree α table (the degree-1 checks have their
    own), an offset, and degree-1 variables and checks; the check kernel at
    each layout of MINSUM_LAYOUTS, its vector launches counted."""
    from ldpc_decoder_tpu_torch.ops import _kernels

    nb, offset = MINSUM_LAYOUTS[layout]
    t, st = _general_state(cuda_device, dtype, 8, nb)
    if offset:
        st["mv"] = _at_odd_offset(st["mv"])
    alpha = ((1, 0.5), (5, 0.9), (0, 0.75))
    before = dict(_kernels.launch_counts)
    rk = G.cn_pass_general_minsum(st["mv"], st["syn"],
                                  torch.empty_like(st["rc"]), t, alpha, 0.25)
    rp = G.cn_pass_general_minsum_plain(st["mv"], st["syn"],
                                        torch.empty_like(st["rc"]), t,
                                        alpha, 0.25)
    assert _same_bits(rk, rp)
    for emit in (False, True):
        bk = torch.full((t.n_vars, nb), -1, dtype=torch.int8,
                        device=cuda_device)
        bp = bk.clone()
        mk = G.vn_pass_general_minsum(st["rc"], st["llr"],
                                      torch.empty_like(st["rc"]), t, 20.0,
                                      bits=bk if emit else None)
        mp = G.vn_pass_general_minsum_plain(st["rc"], st["llr"],
                                            torch.empty_like(st["rc"]), t,
                                            20.0, bits=bp if emit else None)
        assert _same_bits(mk, mp)
        assert torch.equal(bk, bp)
    torch.cuda.synchronize()
    counts = {n: _kernels.launch_counts[n] - before[n]
              for n in ("cn_general_minsum", "cn_general_minsum_vec",
                        "vn_general_minsum")}
    n_cn = len(t.cn_buckets)
    assert counts == {
        "cn_general_minsum": n_cn,
        "cn_general_minsum_vec": n_cn if _minsum_vector(layout, dtype) else 0,
        "vn_general_minsum": 2 * len(t.vn_buckets)}


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [
    dict(message_dtype="float32"),
    dict(message_dtype="int8", algorithm="min-sum", minsum_alpha=0.8,
         minsum_offset=0.0),
])
def test_general_decode_on_card_matches_cpu(cuda_device, kw, monkeypatch):
    """The general path on a small (3,6) code: kernels on the card vs
    plain passes on the CPU; equal words and per-frame iterations, float32
    sum-product on the accurate-φ kernels (bound onto the passes the
    runners call). Then float32 sum-product on the fast kernels, the
    decoder's: every frame the CPU decodes to the reference bits decodes to
    the same bits, and the average iterations are within 5 of the CPU's;
    no accurate kernel launches."""
    from ldpc_decoder_tpu_torch.ops import _kernels

    code = make_regular_code(512, 3, 6, seed=21)
    ch = BIAWGNChannel(0.72)
    n = 3 * 32 + 8
    batch = create_data(code, ch, 0, n, backend="numpy")
    dyn = DynamicParams(num_iter_max=60, num_iter_check_parity=5)

    def decode(dev):
        dec = LDPCDecoder(code, ch, StaticParams(
            parallel_factor_user=32, qc_autodetect=False, **kw), device=dev)
        assert isinstance(dec.tables, G.GeneralTables)
        return dec.decode(dyn, n, batch.values, batch.syndromes)

    sum_product = "algorithm" not in kw
    res_c, st_c = decode("cpu")
    with monkeypatch.context() as m:
        if sum_product:
            for name in ("cn_pass_general", "vn_pass_general"):
                m.setattr(G, name, functools.partial(getattr(G, name),
                                                     _phi="accurate"))
        res_g, st_g = decode(cuda_device)
    np.testing.assert_array_equal(res_g, res_c)
    np.testing.assert_array_equal(st_g.iterations, st_c.iterations)
    ref = batch.ref_bits_packed()
    assert (res_g == ref).all()
    if not sum_product:
        return
    before = _kernels.launch_counts["phi_accurate"]
    res_f, st_f = decode(cuda_device)
    assert _kernels.launch_counts["phi_accurate"] == before
    good = (res_c == ref).all(axis=1)
    np.testing.assert_array_equal(res_f[good], res_c[good])
    assert abs(st_f.avg_iter - st_c.avg_iter) <= 5
    print(f"fast phi: {int((res_f != res_c).any(axis=1).sum())} frames "
          f"differ in words, {int((st_f.iterations != st_c.iterations).sum())}"
          f" in iterations from the CPU's")


def _staircase_structure(D, Z, seed):
    """A D x D base whose row r holds columns 0..r, so the check degrees
    and the variable degrees are each 1..D, with random shifts."""
    rows, cols = np.nonzero(np.tril(np.ones((D, D), np.int8)))
    shifts = np.random.default_rng(seed).integers(0, Z, rows.size)
    return QCStructure(Z=Z, n_base_rows=D, n_base_cols=D,
                       edge_row=rows.astype(np.int32),
                       edge_col=cols.astype(np.int32),
                       edge_shift=shifts.astype(np.int32))


def _msgs(rng, shape, dtype, device):
    """Messages with ties and zeros of both signs: int8 in [-40, 40],
    floats in quarter steps."""
    if dtype == torch.int8:
        return torch.from_numpy(rng.integers(-40, 41, shape).astype(
            np.int8)).to(device)
    x = np.round(rng.standard_normal(shape) * 40) / 4
    return torch.from_numpy(x.astype(np.float32)).to(device, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", sorted(MINSUM_LAYOUTS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8,
                                   torch.float8_e5m2])
def test_grouped_minsum_kernels_match_plain(cuda_device, dtype, layout):
    """Every degree 1..32 on both sides (so degree 1 and 17-32 too), each
    layout of MINSUM_LAYOUTS for the check kernel (the last lane chunk
    guarded), an α table with an offset, fresh lanes (for int8 the lane
    reset writes quantize(clip(llr))): bitwise; the check kernel's vector
    launches counted."""
    from ldpc_decoder_tpu_torch.ops import _kernels

    t = qg.GroupedQCTables.from_qc_tables(QCDecodeTables.from_structure(
        _staircase_structure(32, 16, 3), 0, cuda_device))
    assert [g.degree for g in t.row_groups] == list(range(1, 33))
    assert [g.degree for g in t.col_groups] == list(range(1, 33))
    rng = np.random.default_rng(9)
    nb, offset = MINSUM_LAYOUTS[layout]
    mv = _msgs(rng, (t.nb, t.Z, nb), dtype, cuda_device)
    rc = _msgs(rng, (t.nb, t.Z, nb), dtype, cuda_device)
    llr = torch.from_numpy((rng.standard_normal((t.C, t.Z, nb)) * 12).astype(
        np.float32)).to(cuda_device, G.llr_dtype(dtype))
    syn = torch.from_numpy((rng.random((t.R, t.Z, nb)) < 0.5).astype(
        np.int8)).to(cuda_device)
    fresh = torch.from_numpy(rng.random(nb) < 0.5).to(cuda_device)
    alpha = ((1, 0.5), (17, 0.9), (32, 0.625), (0, 0.75))
    mv_cn = _at_odd_offset(mv) if offset else mv
    before = dict(_kernels.launch_counts)
    rk = qg.cn_pass_grouped_minsum(mv_cn, syn, torch.empty_like(rc), t, alpha,
                                   0.25)
    rp = qg.cn_pass_minsum_plain(mv_cn, syn, torch.empty_like(rc), t, alpha,
                                 0.25)
    assert _same_bits(rk, rp)
    for emit, fr, d1 in [(False, None, False), (True, fresh, False),
                         (False, fresh, True)]:
        bk = torch.full((t.C, t.Z, nb), -1, dtype=torch.int8,
                        device=cuda_device)
        bp = bk.clone()
        mk = qg.vn_pass_grouped_minsum(rc, llr, mv.clone(), t, 20.0,
                                       bits=bk if emit else None, fresh=fr,
                                       include_d1=d1)
        mp = qg.vn_pass_minsum_plain(rc, llr, mv.clone(), t, 20.0,
                                     bits=bp if emit else None, fresh=fr,
                                     include_d1=d1)
        assert _same_bits(mk, mp)
        assert torch.equal(bk, bp)
    torch.cuda.synchronize()
    counts = {n: _kernels.launch_counts[n] - before[n]
              for n in ("cn_group_minsum", "cn_group_minsum_vec",
                        "vn_group_minsum")}
    # non-emit skips the degree-1 group; emit and include_d1 run it
    assert counts == {
        "cn_group_minsum": 32,
        "cn_group_minsum_vec": 32 if _minsum_vector(layout, dtype) else 0,
        "vn_group_minsum": 3 * 32 - 1}


@pytest.mark.cuda
@pytest.mark.parametrize("d_c", [6, 30])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float8_e5m2])
def test_regular_minsum_kernels_match_plain(cuda_device, dtype, d_c):
    from ldpc_decoder_tpu_torch.ops import _kernels

    t = qr.QCRegularTables.from_qc_tables(QCDecodeTables.from_structure(
        _regular_structure(d_c, 96, d_c), 0, cuda_device))
    rng = np.random.default_rng(10)
    nb = B_GENERAL
    mv = _msgs(rng, (t.C, t.d_v, t.Z, nb), dtype, cuda_device)
    rc = _msgs(rng, (t.R, t.d_c, t.Z, nb), dtype, cuda_device)
    llr = torch.from_numpy((rng.standard_normal((t.C, t.Z, nb)) * 12).astype(
        np.float32)).to(cuda_device, G.llr_dtype(dtype))
    syn = torch.from_numpy((rng.random((t.R, t.Z, nb)) < 0.5).astype(
        np.int8)).to(cuda_device)
    fresh = torch.from_numpy(rng.random(nb) < 0.5).to(cuda_device)
    before = dict(_kernels.launch_counts)
    rk = qr.cn_pass_regular_minsum(mv, syn, torch.empty_like(rc), t, 0.8125,
                                   0.25)
    rp = qr.cn_pass_minsum_plain(mv, syn, torch.empty_like(rc), t, 0.8125,
                                 0.25)
    assert _same_bits(rk, rp)
    for emit, fr in [(False, None), (True, fresh), (False, fresh)]:
        bk = torch.full((t.C, t.Z, nb), -1, dtype=torch.int8,
                        device=cuda_device)
        bp = bk.clone()
        mk = qr.vn_pass_regular_minsum(rc, llr, mv.clone(), t, 20.0,
                                       bits=bk if emit else None, fresh=fr)
        mp = qr.vn_pass_minsum_plain(rc, llr, mv.clone(), t, 20.0,
                                     bits=bp if emit else None, fresh=fr)
        assert _same_bits(mk, mp)
        assert torch.equal(bk, bp)
    torch.cuda.synchronize()
    for name, n in (("cn_regular_minsum", 1), ("vn_regular_minsum", 3)):
        assert _kernels.launch_counts[name] - before[name] == n


QC_MINSUM_DECODES = {
    "regular-bf16": ("regular", dict(message_dtype="bfloat16")),
    "regular-int8": ("regular", dict(message_dtype="int8")),
    "p41-int8-alpha-table": ("p41", dict(
        message_dtype="int8", minsum_offset=0.0,
        minsum_alpha={3: 0.8, 6: 0.75, 7: 0.75, 0: 0.8})),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(QC_MINSUM_DECODES))
def test_qc_minsum_decode_on_card_matches_cpu(small_code, cuda_device, case):
    """QC min-sum from the plain code (detection on): kernels on the card
    vs plain passes on the CPU, with refills; equal words and per-frame
    iterations."""
    name, kw = QC_MINSUM_DECODES[case]
    if name == "regular":
        code, _ = make_qc_code(np.ones((3, 6), np.int8), Z=128, seed=1)
        ch = BIAWGNChannel(0.8)
    else:
        code, ch = small_code[0], BIAWGNChannel(0.7)
    n = 3 * 32 + 8
    batch = create_data(code, ch, 0, n, backend="numpy")
    dyn = DynamicParams(num_iter_max=60, num_iter_check_parity=5)
    out = {}
    for dev in ("cpu", cuda_device):
        dec = LDPCDecoder(code, ch, StaticParams(
            parallel_factor_user=32, algorithm="min-sum", **kw), device=dev)
        assert dec.qc is not None
        out[str(dev)] = dec.decode(dyn, n, batch.values, batch.syndromes)
    (res_c, st_c), (res_g, st_g) = out["cpu"], out[str(cuda_device)]
    np.testing.assert_array_equal(res_g, res_c)
    np.testing.assert_array_equal(st_g.iterations, st_c.iterations)


# ---- float8_e5m2 ------------------------------------------------------------

FP8 = torch.float8_e5m2


def _fp8_close(k, p, share=1e-3):
    """float8_e5m2 kernel vs plain sum-product messages: signs exact, at
    most one e5m2 step apart, on a share of at most ``share``."""
    a, b = k.view(torch.uint8).int(), p.view(torch.uint8).int()
    assert torch.equal(a >> 7, b >> 7), "signs differ"
    assert int(((a & 0x7F) - (b & 0x7F)).abs().max()) <= 1
    assert float((a != b).float().mean()) <= share


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["grouped", "regular-6", "regular-30"])
def test_fp8_kernels_match_plain(small_code, cuda_device, family):
    """The float8_e5m2 sum-product kernels (φ clamped at 80 in the grouped
    family, at 10 in the regular one) against their plain versions, with
    fresh lanes and emits; their launches counted apart."""
    from ldpc_decoder_tpu_torch.ops import _kernels

    if family == "grouped":
        code, s = small_code
        t = qg.GroupedQCTables.from_qc_tables(QCDecodeTables.from_structure(
            s, code.n_erased_vars, cuda_device))
        mod, cn_name, vn_name = qg, "cn_fp8", "vn_fp8"
        mv_shape = rc_shape = (t.nb, t.Z, B)
        runs = [(False, None, False), (True, True, False), (False, True, True)]
    else:
        d_c = int(family.split("-")[1])
        t = qr.QCRegularTables.from_qc_tables(QCDecodeTables.from_structure(
            _regular_structure(d_c, 96, d_c), 0, cuda_device))
        mod, cn_name, vn_name = qr, "cn_regular_fp8", "vn_regular_fp8"
        mv_shape, rc_shape = (t.C, t.d_v, t.Z, B), (t.R, t.d_c, t.Z, B)
        runs = [(False, None, None), (True, True, None), (False, True, None)]
    rng = np.random.default_rng(11)

    def rand(shape, scale, dtype):
        x = rng.standard_normal(shape).astype(np.float32) * scale
        return torch.from_numpy(x).to(cuda_device, dtype)

    mv, rc = rand(mv_shape, 6, FP8), rand(rc_shape, 6, FP8)
    llr = rand((t.C, t.Z, B), 8, torch.bfloat16)
    syn = torch.from_numpy((rng.random((t.R, t.Z, B)) < 0.5).astype(
        np.int8)).to(cuda_device)
    fresh = torch.from_numpy(rng.random(B) < 0.5).to(cuda_device)
    # both families on their accurate-φ instantiation (the fast one:
    # test_grouped_kernels_both_phi, test_regular_kernels_both_phi)
    cn_k = functools.partial(
        qg.cn_pass_grouped if mod is qg else qr.cn_pass_regular,
        _phi="accurate")
    vn_k = functools.partial(
        qg.vn_pass_grouped if mod is qg else qr.vn_pass_regular,
        _phi="accurate")
    before = dict(_kernels.launch_counts)
    rk = cn_k(mv, syn, torch.empty_like(rc), t)
    rp = mod.cn_pass_plain(mv, syn, torch.empty_like(rc), t)
    _fp8_close(rk, rp)
    for emit, fr, d1 in runs:
        bk = torch.full((t.C, t.Z, B), -1, dtype=torch.int8,
                        device=cuda_device)
        bp = bk.clone()
        kw = dict(fresh=fresh if fr else None)
        if d1 is not None:
            kw["include_d1"] = d1
        mk = vn_k(rc, llr, mv.clone(), t, bits=bk if emit else None, **kw)
        mp = mod.vn_pass_plain(rc, llr, mv.clone(), t,
                               bits=bp if emit else None, **kw)
        _fp8_close(mk, mp)
        assert torch.equal(bk, bp)
    torch.cuda.synchronize()
    n_cn = len(t.row_groups) if mod is qg else 1
    n_vn = 3 * len(t.col_groups) - 1 if mod is qg else 3
    assert _kernels.launch_counts[cn_name] - before[cn_name] == n_cn
    assert _kernels.launch_counts[vn_name] - before[vn_name] == n_vn
    for name in ("cn", "vn", "cn_regular", "vn_regular"):
        assert _kernels.launch_counts[name] == before[name]


@pytest.mark.cuda
def test_fp8_store_matches_torch(cuda_device):
    """The kernels' float8_e5m2 store against torch's conversion on the card
    and on the CPU, for every bfloat16 value but NaN: ties, subnormals, ±0,
    57344, the overflow to ±inf. The stored values go through a regular
    min-sum variable pass whose lanes are all fresh and whose clamp is
    infinite, so each slot stores its llr as it is."""
    t = qr.QCRegularTables.from_qc_tables(QCDecodeTables.from_structure(
        _regular_structure(6, 64, 1), 0, cuda_device))
    every = torch.arange(1 << 16, dtype=torch.int32).to(torch.int16)
    vals = every.view(torch.bfloat16)
    vals = vals[~torch.isnan(vals)]
    n = t.C * t.Z
    B_store = -(-vals.numel() // n)
    llr = torch.zeros(n * B_store, dtype=torch.bfloat16)
    llr[:vals.numel()] = vals
    llr = llr.view(t.C, t.Z, B_store).to(cuda_device)
    rc = torch.zeros((t.R, t.d_c, t.Z, B_store), dtype=FP8,
                     device=cuda_device)
    mv = torch.empty((t.C, t.d_v, t.Z, B_store), dtype=FP8,
                     device=cuda_device)
    qr.vn_pass_regular_minsum(rc, llr, mv, t, float("inf"),
                              fresh=torch.ones(B_store, dtype=torch.bool,
                                               device=cuda_device))
    kernel = mv[:, 0].reshape(-1)[:vals.numel()].view(torch.uint8).cpu()
    on_card = llr.reshape(-1)[:vals.numel()].to(FP8).view(torch.uint8).cpu()
    on_cpu = vals.to(FP8).view(torch.uint8)
    assert torch.equal(on_card, on_cpu)
    assert torch.equal(kernel, on_cpu)
    for k in range(1, t.d_v):
        assert _same_bits(mv[:, k], mv[:, 0])
    picks = torch.tensor([0.0, -0.0, 1.125, 1.375, 2.0 ** -16, 3 * 2.0 ** -17,
                          57344.0, 61440.0, -1e6], dtype=torch.bfloat16)
    assert torch.isin(picks.view(torch.int16), vals.view(torch.int16)).all()


@pytest.mark.cuda
def test_fp8_store_float32_matches_torch(cuda_device):
    """The kernels' float8_e5m2 store of float32 values with nonzero low
    mantissa bits (every sum-product φ store has them) against torch's
    conversion on the card and on the CPU: random values, and the values
    one float32 ulp either side of every tie between adjacent e5m2 values
    (subnormal ties and the overflow tie 61440 included). A regular min-sum
    check pass with β = 0 makes them: the messages of a lane all equal m
    (an e5m2 value), so every slot stores α·m, rounded once to float32 and
    then to e5m2."""
    t = qr.QCRegularTables.from_qc_tables(QCDecodeTables.from_structure(
        _regular_structure(6, 64, 1), 0, cuda_device))
    rng = np.random.default_rng(5)
    pow2 = torch.tensor(2.0 ** np.arange(-16, 16), dtype=torch.float32)
    finite = torch.arange(1, 0x7C, dtype=torch.uint8).view(FP8).float()
    rand_m = finite[torch.from_numpy(rng.integers(0, finite.numel(), 64))]
    rand_m = rand_m * torch.from_numpy(rng.choice([-1.0, 1.0], 64)).float()
    m = torch.cat([pow2, -pow2, rand_m])  # [B] one message value per lane
    B = m.numel()
    mv = m.to(FP8).view(1, 1, 1, B).expand(t.C, t.d_v, t.Z, B).contiguous()
    mv = mv.to(cuda_device)
    syn = torch.zeros((t.R, t.Z, B), dtype=torch.int8, device=cuda_device)
    rc = torch.empty((t.R, t.d_c, t.Z, B), dtype=FP8, device=cuda_device)
    # α·2^j spans every tie: normal ones at 1.125..1.875 · 2^j, subnormal
    # ones at 0.5, 1.5, 2.5, 3.5 · 2^-16
    ties = np.array([0.5, 1.125, 1.25, 1.375, 1.5, 1.625, 1.75, 1.875],
                    np.float32)
    alphas = np.concatenate([
        np.nextafter(ties, np.float32(0)), ties,
        np.nextafter(ties, np.float32(np.inf)),
        rng.uniform(0.5, 2.0, 8).astype(np.float32)])
    seen = []
    for a in alphas:
        qr.cn_pass_regular_minsum(mv, syn, rc, t, float(a), 0.0)
        # the kernel's float32 product α·|m| (__fmul_rn), with m's sign
        want = torch.tensor(a, dtype=torch.float32) * m
        seen.append(want)
        kernel = rc.view(torch.uint8).cpu()
        on_cpu = want.to(FP8).view(torch.uint8)
        on_card = want.to(cuda_device).to(FP8).view(torch.uint8).cpu()
        assert torch.equal(on_card, on_cpu), a
        assert torch.equal(kernel, on_cpu.expand_as(kernel)), a
    seen = torch.cat(seen)
    for tie in (61440.0, 1.5 * 2.0 ** -16, 1.125 * 2.0 ** -14):
        below, above = np.nextafter(np.float32([tie, tie]),
                                    np.float32([0, np.inf]))
        assert (seen == float(below)).any() and (seen == float(above)).any()


@pytest.mark.cuda
def test_cuda_numerics_smoke(cuda_device):
    from ldpc_decoder_tpu_torch.runtime.smoke import cuda_numerics_smoke

    out = cuda_numerics_smoke(cuda_device, verbose=lambda _: None)
    assert out["phi_max_rel_err"] < 1e-5
    assert out["phi10_e5m2"] == 1.5 * 2.0 ** -14


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["regular-sum-product", "p41-sum-product",
                                  "p41-min-sum"])
def test_fp8_decode_on_card_matches_cpu(small_code, cuda_device, case):
    """float8_e5m2 decodes with refills: kernels on the card vs plain passes
    on the CPU; equal words and per-frame iterations."""
    family, alg = case.split("-", 1)
    if family == "regular":
        code, s = make_qc_code(np.ones((3, 6), np.int8), Z=128, seed=1)
        ch, want = BIAWGNChannel(0.7), qr.QCRegularTables
    else:
        (code, s), ch, want = small_code, BIAWGNChannel(0.7), \
            qg.GroupedQCTables
    n = 3 * 32 + 8
    batch = create_data(code, ch, 0, n, backend="numpy")
    dyn = DynamicParams(num_iter_max=60, num_iter_check_parity=5)
    out = {}
    for dev in ("cpu", cuda_device):
        dec = LDPCDecoder(code, ch, StaticParams(
            parallel_factor_user=32, message_dtype="float8_e5m2",
            algorithm=alg), qc=s, device=dev)
        assert isinstance(dec.tables, want)
        out[str(dev)] = dec.decode(dyn, n, batch.values, batch.syndromes)
    (res_c, st_c), (res_g, st_g) = out["cpu"], out[str(cuda_device)]
    np.testing.assert_array_equal(res_g, res_c)
    np.testing.assert_array_equal(st_g.iterations, st_c.iterations)


@pytest.mark.cuda
def test_cli_on_card(cuda_device, tmp_path, capsys):
    """The CLI's default device is the card: a small QC code decodes with
    no bit error, the phase timings printed at log level 2."""
    from ldpc_decoder_tpu_torch.cli import main
    from ldpc_decoder_tpu_torch.codes.qc import write_qc_alist

    code, s = make_qc_code(np.ones((3, 6), np.int8), Z=128, seed=1)
    path = tmp_path / "qc36.alist"
    write_qc_alist(code, s, str(path))
    assert main(["-f", str(path), "-c", "1", "-n", "0.7", "-p", "5", "-m",
                 "2", "-e", "15", "-i", "60", "-l", "2"]) == 0
    out = capsys.readouterr().out
    assert "Bit error rate (BER):             0\n" in out
    assert "Phase timings (per call):" in out


@pytest.mark.cuda
def test_probe_kernels_match_plain(cuda_device):
    """Every mode of both probe kernels (csrc/probes.cu) against its plain
    version: the row copy by table and int32/int64 index at every bytes per
    thread, the window stream's sums and leave-one-out, aligned, direct and
    staged (the leave-one-out stages six windows by bulk copies), on the
    accurate φ and, at its two shapes, the fast one. Copies, sums and
    stubbed φ bit for bit, live φ by the one-ulp share rule
    (compare_msgs, compare_msgs_fast on the fast φ)."""
    from ldpc_decoder_tpu_torch import probes
    from ldpc_decoder_tpu_torch.ops import _kernels

    before = dict(_kernels.launch_counts)
    errs = probes.check_template_modes(cuda_device, small=True)
    torch.cuda.synchronize()
    assert len(errs) == 90
    assert _kernels.launch_counts["probe_row_copy"] - before[
        "probe_row_copy"] == 15
    assert _kernels.launch_counts["probe_window"] - before[
        "probe_window"] == 75


@pytest.mark.cuda
def test_probe_window_ragged_lanes(cuda_device):
    """A lane count that fills neither a 128-lane nor a 64-lane block, and
    more rows per thread than a block needs."""
    from ldpc_decoder_tpu_torch.probes import _common as C
    from ldpc_decoder_tpu_torch.probes.kernels import (
        window_stream,
        window_stream_plain,
    )

    src = C.randn((16, 256, 200), torch.bfloat16, cuda_device, seed=1)
    blocks = C.permutation(16, cuda_device, seed=2)[:12].contiguous()
    shifts = C.integers(12, 256, cuda_device, seed=3)
    syn = C.randn((2, 256, 200), torch.int8, cuda_device,
                  seed=4).bitwise_and_(1)
    for mode, rows in (("aligned", 3), ("direct", 256), ("staged", 8)):
        for out, s in (("sum", None), ("loo", syn)):
            res = window_stream(src, blocks, shifts, 6, 1, mode, out, False,
                                s, rows=rows)
            ref = window_stream_plain(src, blocks, shifts, 6, 1, out, False,
                                      s)
            C.assert_bit_equal(res, ref, f"{mode} {out}")


def _window_case(device, Z, W, degree, seed, shifts=None):
    from ldpc_decoder_tpu_torch.probes import _common as C

    n = 2
    src = C.randn((16, Z, W), torch.bfloat16, device, seed=seed, offset=1.5)
    blocks = C.permutation(16, device, seed=seed + 1)[:n * degree].contiguous()
    if shifts is None:
        shifts = C.integers(n * degree, Z, device, seed=seed + 2)
    syn = C.randn((n, Z, W), torch.int8, device,
                  seed=seed + 3).bitwise_and_(1)
    return src, blocks, shifts, syn


def _check_window(src, blocks, shifts, syn, degree, mode, rows=8):
    """Sum and leave-one-out, φ stubbed (bit for bit) and live (accurate:
    compare_msgs; fast where instantiated: compare_msgs_fast)."""
    from ldpc_decoder_tpu_torch.probes import _common as C
    from ldpc_decoder_tpu_torch.probes.kernels import (
        FAST_SHAPES,
        WINDOW_SHAPES,
        window_stream,
        window_stream_plain,
    )

    for out, s in (("sum", None), ("loo", syn)):
        if (degree, 1) not in WINDOW_SHAPES[out]:
            continue
        for live, phi in ((False, "accurate"), (True, "accurate"),
                          (True, "fast")):
            if phi == "fast" and (degree, 1) not in FAST_SHAPES[out]:
                continue
            res = window_stream(src, blocks, shifts, degree, 1, mode, out,
                                live, s, rows=rows, phi=phi)
            ref = window_stream_plain(src, blocks, shifts, degree, 1, out,
                                      live, s)
            C.window_rule(1, live, phi)(res, ref, f"{mode} {out} "
                                        f"live={live} {phi}")


@pytest.mark.cuda
@pytest.mark.parametrize("degree", [1, 6])
def test_staged_window_wraps_past_z(cuda_device, degree):
    """Staged windows whose rows pass Z inside a block: each block copies
    two runs (shifts Z - 1, Z - 5, Z - R + 1 and 1, beside 0), and every
    mode agrees with plain."""
    from ldpc_decoder_tpu_torch.probes.kernels import window_plan

    Z, W = 512, 128
    R = window_plan("staged", degree, "loo" if degree == 6 else "sum", Z, W,
                    2)["stage_rows"]
    pick = [Z - 1, Z - 5, Z - R + 1, 1, 0, Z // 2][:2 * degree]
    shifts = torch.tensor((pick * 2)[:2 * degree], dtype=torch.int32,
                          device=cuda_device)
    case = _window_case(cuda_device, Z, W, degree, 40, shifts)
    for mode in ("staged", "direct", "aligned"):
        _check_window(*case, degree, mode)


@pytest.mark.cuda
@pytest.mark.parametrize("Z", [100, 33, 1000])
def test_window_partial_last_block(cuda_device, Z):
    """A Z whose last row block is partial (staged blocks of 64 and 32
    rows at W = 128; 8 rows per thread, 8 rows side by side, aligned and
    direct)."""
    for degree in (1, 6):
        case = _window_case(cuda_device, Z, 128, degree, 50)
        for mode in ("staged", "direct", "aligned"):
            _check_window(*case, degree, mode)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["aligned", "direct", "staged"])
def test_window_refuses_what_the_lanes_cannot_take(cuda_device, mode):
    """On the card a W off the 8-lane vectors, or a tensor off a 16-byte
    boundary, raises ValueError: there is no one-lane kernel to fall back
    to, and nothing is launched."""
    from ldpc_decoder_tpu_torch.ops import _kernels
    from ldpc_decoder_tpu_torch.probes.kernels import window_stream

    before = _kernels.launch_counts["probe_window"]
    src, blocks, shifts, syn = _window_case(cuda_device, 64, 36, 6, 60)
    for out, s in (("sum", None), ("loo", syn)):
        with pytest.raises(ValueError, match="multiple"):
            window_stream(src, blocks, shifts, 6, 1, mode, out, True, s)
    src, blocks, shifts, syn = _window_case(cuda_device, 64, 32, 6, 61)
    flat = torch.empty(src.numel() + 8, dtype=src.dtype, device=cuda_device)
    odd = flat[1:1 + src.numel()].view(src.shape).copy_(src)
    with pytest.raises(ValueError, match="aligned"):
        window_stream(odd, blocks, shifts, 6, 1, mode, "sum")
    flat8 = torch.empty(syn.numel() + 16, dtype=torch.int8,
                        device=cuda_device)
    odd_syn = flat8[8:8 + syn.numel()].view(syn.shape).copy_(syn)
    with pytest.raises(ValueError, match="aligned"):
        window_stream(src, blocks, shifts, 6, 1, mode, "loo", True, odd_syn)
    res = torch.empty((2, 64, 32), dtype=src.dtype, device=cuda_device)
    flat_out = torch.empty(res.numel() + 8, dtype=src.dtype,
                           device=cuda_device)
    with pytest.raises(ValueError, match="aligned"):
        window_stream(src, blocks, shifts, 6, 1, mode, "sum",
                      result=flat_out[4:4 + res.numel()].view(res.shape))
    assert _kernels.launch_counts["probe_window"] == before


@pytest.mark.cuda
def test_probe_library_matches_its_mirror(cuda_device):
    """The library's launch plans and staged runs equal the Python mirror
    (checked at load; again here explicitly)."""
    from ldpc_decoder_tpu_torch.ops import _kernels
    from ldpc_decoder_tpu_torch.probes.kernels import check_library

    check_library(_kernels.load("probes"))


@pytest.mark.cuda
def test_probe_headlines_on_card(cuda_device):
    """The probe entry point's one-point runs, held against their plain
    versions inside each probe: every probe returns a timed record."""
    from ldpc_decoder_tpu_torch import probes

    for name in ("rotated_copy", "overlap2", "window_read"):
        recs = probes.PROBES[name](cuda_device, small=True, headline=True)
        assert recs and recs[0]["ms"] > 0 and recs[0]["plain_ms"] > 0
        assert recs[0]["max_abs_err"] is not None


# ---- the parity kernels (csrc/parity.cuh) ------------------------------------

# parity kernel layouts: (B, tensors at an odd offset); 256 and 64 take the
# vector instantiation (16 lanes a thread), the ragged 40 and 37 and the
# offset view one lane
PARITY_LAYOUTS = {"256": (256, False), "64": (64, False), "40": (40, False),
                  "37": (37, False), "64 at an odd offset": (64, True)}


def _parity_tables(family, device):
    """Tables with every instantiated check degree: the grouped staircase
    base (degrees 1..16, one launch each), or the regular (3, d_c) bases,
    d_c 1..32, one launch each."""
    if family == "grouped":
        return [qg.GroupedQCTables.from_qc_tables(QCDecodeTables.from_structure(
            _staircase_structure(16, 32, 4), 0, device))]
    return [qr.QCRegularTables.from_qc_tables(QCDecodeTables.from_structure(
        _regular_structure(d_c, 32, d_c), 0, device)) for d_c in range(1, 33)]


def _syndromes(bits, t):
    """The syndromes [R, Z, B] of which ``bits`` is a word: each check row's
    rotated bits summed, mod 2."""
    if isinstance(t, qr.QCRegularTables):
        read = t.cn_read
        x = bits[read[..., 0:1].long(), qr._rows(read, t.Z)]
        return (x.sum(dim=1) & 1).to(torch.int8)
    syn = torch.empty((t.R, t.Z, bits.shape[-1]), dtype=torch.int8,
                      device=bits.device)
    for g in t.row_groups:
        sl = slice(g.block_start, g.block_start + g.count * g.degree)
        x = qg._rotated(bits, t.par_src[sl], t.par_shift[sl], t.Z)
        syn[g.node_start:g.node_start + g.count] = (x.view(
            g.count, g.degree, t.Z, -1).sum(dim=1) & 1).to(torch.int8)
    return syn


@pytest.mark.cuda
@pytest.mark.parametrize("data", ["arbitrary int8", "flipped checks"])
@pytest.mark.parametrize("layout", sorted(PARITY_LAYOUTS))
@pytest.mark.parametrize("family", ["grouped", "regular"])
def test_parity_kernels_match_plain(cuda_device, family, layout, data):
    """Every instantiated degree, each layout of PARITY_LAYOUTS, arbitrary
    int8 bits and syndromes (every third lane made even) or 0/1 words with
    three checks flipped: the flags equal the plain pass's exactly, through
    the decoder's launch and at every grid slice of 16 lanes up; the
    vector launches counted."""
    from ldpc_decoder_tpu_torch.ops import _kernels

    mod = qg if family == "grouped" else qr
    kernel = (qg.parity_pass_grouped if family == "grouped"
              else qr.parity_pass_regular)
    B, offset = PARITY_LAYOUTS[layout]
    rng = np.random.default_rng(17)
    vector = B % 16 == 0 and not offset
    n_launches = 0
    before = dict(_kernels.launch_counts)
    for t in _parity_tables(family, cuda_device):
        if data == "arbitrary int8":
            bits, syn = (torch.from_numpy(rng.integers(
                -128, 128, (n, t.Z, B)).astype(np.int8)).to(cuda_device)
                for n in (t.C, t.R))
            even = torch.arange(B, device=cuda_device) % 3 == 0
            bits[..., even] &= ~1
            syn[..., even] &= ~1
            want = (torch.arange(B) % 3 != 0).tolist()
        else:
            bits = torch.from_numpy((rng.random((t.C, t.Z, B)) < 0.5).astype(
                np.int8)).to(cuda_device)
            syn = _syndromes(bits, t)
            bad = [0, 5, B - 1]
            syn[t.R - 1, t.Z - 1, bad] ^= 1
            want = [b in bad for b in range(B)]
        if offset:
            bits, syn = _at_odd_offset(bits), _at_odd_offset(syn)
        plain = mod.parity_pass_plain(bits, syn, t)
        assert plain.tolist() == want
        assert torch.equal(kernel(bits, syn, t), plain)
        for slice_lanes in (16, 32, 64, 128, 256):
            flags = mod.parity_kernel_flags(bits, syn, t,
                                            slice_lanes=slice_lanes)
            assert torch.equal(flags != 0, plain), slice_lanes
            assert set(flags.unique().tolist()) <= {0, 1}
        n_launches += 6 * (len(t.row_groups) if family == "grouped" else 1)
    torch.cuda.synchronize()
    name = "parity" if family == "grouped" else "parity_regular"
    assert _kernels.launch_counts[name] - before[name] == n_launches
    assert _kernels.launch_counts[f"{name}_vec"] - before[f"{name}_vec"] == (
        n_launches if vector else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["grouped", "regular"])
def test_parity_one_lane_matches_vector(cuda_device, family):
    """At B = 256 the one-lane instantiation, asked for, gives the vector
    one's flags, with and without slices."""
    mod = qg if family == "grouped" else qr
    rng = np.random.default_rng(18)
    for t in _parity_tables(family, cuda_device)[::7]:
        bits = torch.from_numpy((rng.random((t.C, t.Z, 256)) < 0.5).astype(
            np.int8)).to(cuda_device)
        syn = _syndromes(bits, t)
        syn[0, 3, [7, 100]] ^= 1
        for slice_lanes in (None, 32):
            one = mod.parity_kernel_flags(bits, syn, t, lanes=1,
                                          slice_lanes=slice_lanes)
            vec = mod.parity_kernel_flags(bits, syn, t,
                                          slice_lanes=slice_lanes)
            assert torch.equal(one, vec)
            assert torch.nonzero(one).flatten().tolist() == [7, 100]


# ---- pool generation (csrc/datagen.cu) --------------------------------------

# (n_vars, n_tx, start, n_frames): a whole number of blocks; a ragged
# n_vars with an erased tail; a start whose seeds wrap past 2^32; D1 at 1,
# 2, 3, 16 and 64 groups of 32 frames (its tiles: every lane computes at
# any group count) and at 17 (a last tile of one group), 64 the pools'
# chunk, 512 and 2048 the qualification's
DATAGEN_SHAPES = [(512, 512, 9, 96), (1031, 900, 2**32 - 40, 64),
                  (4101, 4101, 3, 96), (1031, 1031, 5, 32),
                  (777, 700, 11, 512), (300, 300, 2**32 - 1000, 2048),
                  (4101, 4000, 7, 64), (257, 200, 13, 544)]


@pytest.mark.cuda
@pytest.mark.parametrize("n_vars,n_tx,start,n", DATAGEN_SHAPES)
def test_chacha_bits_kernel_matches_plain(cuda_device, n_vars, n_tx, start,
                                          n):
    """D1: the bits and the packed words equal the plain version's on the
    card and the CPU's, one launch a call."""
    from ldpc_decoder_tpu_torch.ops import _kernels
    from ldpc_decoder_tpu_torch.rng import chacha_torch as ct

    before = _kernels.launch_counts["chacha_bits"]
    bits, packed = ct.reference_bits_packed(start, n_vars, n, cuda_device)
    torch.cuda.synchronize()
    assert _kernels.launch_counts["chacha_bits"] == before + 1
    plain = ct.reference_bits_plain(start, n_vars, n, cuda_device)
    assert torch.equal(bits, plain)
    assert torch.equal(packed, ct.pack_rows(plain, (n_vars + 31) // 32))
    cpu_bits, cpu_packed = ct.reference_bits_packed(start, n_vars, n, "cpu")
    assert torch.equal(bits.cpu(), cpu_bits)
    assert torch.equal(packed.cpu(), cpu_packed)


def _values_case(ct, device, n_vars, start, n):
    """Reference bits of n frames (a multiple of 32 or not) and a sorted
    order for them."""
    bits = ct.reference_bits(start, n_vars, -(-n // 32) * 32, device)
    pos = torch.from_numpy(np.random.default_rng(n_vars).permutation(
        n_vars).astype(np.int32)).to(device)
    return bits[:, :n].contiguous(), pos


@pytest.mark.cuda
@pytest.mark.parametrize("channel,noise", [("bsc", 0.07), ("erasure", 0.3),
                                           ("awgn", 0.9)])
@pytest.mark.parametrize("n_vars,n_tx,start,n", DATAGEN_SHAPES)
def test_channel_values_kernel_matches_plain(cuda_device, channel, noise,
                                             n_vars, n_tx, start, n):
    """D2's vector instantiation (four frames a store) equals its plain
    version on the card bit for bit (AWGN too: the plain version's log and
    cos are the same CUDA library functions), with the erased tail 0.0 and
    each variable in its sorted row; written into an aligned column slice
    of a wider pool, it leaves the other columns alone."""
    from ldpc_decoder_tpu_torch.ops import _kernels
    from ldpc_decoder_tpu_torch.rng import chacha_torch as ct

    bits, pos = _values_case(ct, cuda_device, n_vars, start, n)
    pool = torch.full((n_vars, 3 * n), float("nan"), device=cuda_device)
    before = dict(_kernels.launch_counts)
    out = ct.channel_values(bits, start, channel, noise, n_tx=n_tx, pos=pos,
                            out=pool[:, n:2 * n])
    torch.cuda.synchronize()
    for name in ("channel_values", "channel_values_vec"):
        assert _kernels.launch_counts[name] == before[name] + 1, name
    want = ct.channel_values_plain(bits, start, channel, noise, n_tx, pos)
    assert perf.bit_identical(out, want)
    assert torch.isnan(pool[:, :n]).all() and torch.isnan(pool[:, 2 * n:]).all()
    natural = ct.channel_values(bits, start, channel, noise)
    full = ct.channel_values_plain(bits, start, channel, noise)
    assert perf.bit_identical(natural, full)


@pytest.mark.cuda
@pytest.mark.parametrize("channel,noise", [("bsc", 0.07), ("erasure", 0.3),
                                           ("awgn", 0.9)])
@pytest.mark.parametrize("n_vars,n_tx,start,n,offset", [
    (1031, 900, 2**32 - 40, 62, 0),   # n_frames not a multiple of 4
    (777, 700, 11, 64, 1),            # a column slice at an odd offset
    (4101, 4000, 7, 64, 2),           # 8 bytes in: rows not on 16 bytes
    (300, 300, 3, 7, 5)])
def test_channel_values_one_lane_matches_plain(cuda_device, channel, noise,
                                               n_vars, n_tx, start, n,
                                               offset):
    """D2's one-lane instantiation takes what the vector one cannot (its
    launches not counted under channel_values_vec) and equals the plain
    version bit for bit, and the vector instantiation on the same frames
    where their count allows it."""
    from ldpc_decoder_tpu_torch.ops import _kernels
    from ldpc_decoder_tpu_torch.rng import chacha_torch as ct

    bits, pos = _values_case(ct, cuda_device, n_vars, start, n)
    pool = torch.full((n_vars, n + 8), float("nan"), device=cuda_device)
    out = pool[:, offset:offset + n]
    assert ct.channel_values_frames(out, bits) == 1
    before = dict(_kernels.launch_counts)
    ct.channel_values(bits, start, channel, noise, n_tx=n_tx, pos=pos,
                      out=out)
    torch.cuda.synchronize()
    assert _kernels.launch_counts["channel_values"] == before[
        "channel_values"] + 1
    assert _kernels.launch_counts["channel_values_vec"] == before[
        "channel_values_vec"]
    want = ct.channel_values_plain(bits, start, channel, noise, n_tx, pos)
    assert perf.bit_identical(out.contiguous(), want)
    assert torch.isnan(pool[:, :offset]).all()
    assert torch.isnan(pool[:, offset + n:]).all()
    if n % 4 == 0:
        vec = ct.channel_values(bits, start, channel, noise, n_tx=n_tx,
                                pos=pos)
        assert _kernels.launch_counts["channel_values_vec"] == before[
            "channel_values_vec"] + 1
        assert perf.bit_identical(vec, out.contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("channel", ["bsc", "erasure", "awgn"])
def test_pool_on_card_matches_host_and_cpu(cuda_device, channel):
    """create_pool_device on a CUDA decoder goes through D1 and D2 (one
    launch each per chunk, D2's vector instantiation) and equals the CPU
    decoder's pool (AWGN: bits, syndromes and words exact, values within 2
    ulps of the CPU's log and cos) and, for BSC and erasure, the host
    datagen's upload, erased tail included (the small p41 code punctures 4
    Z-blocks)."""
    from ldpc_decoder_tpu_torch.channels import (
        BIAWGNChannel as Awgn,
        BSCChannel,
        ErasureChannel,
    )
    from ldpc_decoder_tpu_torch.ops import _kernels
    from ldpc_decoder_tpu_torch.runtime.datagen_device import (
        create_pool_device,
    )

    code, s = p41_code(**SMALL)
    ch = {"bsc": BSCChannel(0.05), "erasure": ErasureChannel(0.3),
          "awgn": Awgn(0.8)}[channel]
    sp = StaticParams(parallel_factor_user=32)
    dec = LDPCDecoder(code, ch, sp, qc=s, device=cuda_device)
    cpu = LDPCDecoder(code, ch, sp, qc=s, device="cpu")
    before = dict(_kernels.launch_counts)
    pool = create_pool_device(dec, ch, 7, 128, chunk_frames=64)
    torch.cuda.synchronize()
    for name in ("chacha_bits", "channel_values", "channel_values_vec"):
        assert _kernels.launch_counts[name] - before[name] == 2
    ref = create_pool_device(cpu, ch, 7, 128, chunk_frames=128)
    assert torch.equal(pool.syn_sorted.cpu(), ref.syn_sorted)
    assert torch.equal(pool.ref_packed.cpu(), ref.ref_packed)
    if channel == "awgn":
        torch.testing.assert_close(pool.values_sorted.cpu(),
                                   ref.values_sorted, rtol=2.4e-7, atol=5e-7)
        return
    assert perf.bit_identical(pool.values_sorted.cpu(), ref.values_sorted)
    batch = create_data(code, ch, 7, 128, backend="numpy")
    pv, ps = cpu.upload_pools(batch.values, batch.syndromes)
    assert perf.bit_identical(pool.values_sorted.cpu(), pv)
    assert torch.equal(pool.syn_sorted.cpu(), ps)


# ---- the host-fed stream (decode_streamed) ----------------------------------

STREAM_SIZES = (64, 29, 40, 7)  # two fills, under B, a refill, the last


def _stream_threads():
    from ldpc_decoder_tpu_torch.runtime.decoder import STREAM_THREAD

    return [t for t in threading.enumerate()
            if t.name.startswith(STREAM_THREAD)]


def _stream_case(small_code, device):
    code, s = small_code
    ch = BIAWGNChannel(0.7)
    batch = create_data(code, ch, 0, sum(STREAM_SIZES), backend="numpy")
    edges = np.cumsum((0,) + STREAM_SIZES)
    chunks = [(batch.values[:, a:b], batch.syndromes[:, a:b])
              for a, b in zip(edges[:-1], edges[1:])]
    dec = LDPCDecoder(code, ch, StaticParams(parallel_factor_user=32),
                      qc=s, device=device)
    dyn = DynamicParams(num_iter_max=60, num_iter_check_parity=5,
                        num_iter_first_check=7)
    return dec, dyn, chunks, batch.ref_bits_packed(), edges


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [1, 2, 3])
def test_streamed_matches_serial_on_card(small_code, cuda_device, depth):
    """decode_streamed on the card: every chunk's words and per-frame
    iterations equal a serial decode() of it, the arrays kept to the end
    still equal and disjoint, each chunk's events in stream order
    (upload, then decode, then readback), the worker joined."""
    dec, dyn, chunks, ref, edges = _stream_case(small_code, cuda_device)
    serial = [dec.decode(dyn, v.shape[1], v, s) for v, s in chunks]
    kept = list(dec.decode_streamed(dyn, iter(chunks), depth=depth))
    assert not _stream_threads()
    for i, ((res, st), (sres, sst)) in enumerate(zip(kept, serial)):
        np.testing.assert_array_equal(res, sres)
        np.testing.assert_array_equal(st.iterations, sst.iterations)
        np.testing.assert_array_equal(res, ref[edges[i]:edges[i + 1]])
        ev = st.events
        assert ev["upload_end"].elapsed_time(ev["decode_start"]) >= 0
        assert ev["decode_start"].elapsed_time(ev["decode_end"]) > 0
        assert ev["decode_end"].elapsed_time(ev["readback_end"]) >= 0
        assert st.decode_seconds <= st.elapsed_seconds
        for other, _ in kept[:i]:
            assert not np.shares_memory(res, other)


@pytest.mark.cuda
def test_streamed_staging_is_pinned(small_code, cuda_device):
    """The ring holds depth slots of pinned host buffers (values,
    syndromes, results), reused across chunks; the route's gather on the
    card equals numpy's permutation bit for bit."""
    dec, dyn, chunks, _, _ = _stream_case(small_code, cuda_device)
    slots = []
    stage = dec._stage

    def spy(values, syndromes, slot):
        slots.append(slot)
        return stage(values, syndromes, slot)

    dec._stage = spy
    list(dec.decode_streamed(dyn, iter(chunks), depth=2))
    assert len(slots) == len(chunks) and len({id(x) for x in slots}) == 2
    for slot in slots:
        assert sorted(slot._bufs) == ["results", "syndromes", "values"]
        assert all(buf.is_pinned() for buf in slot._bufs.values())
    v, s = chunks[1]
    pv, ps = dec.upload_pools(v, s)
    np.testing.assert_array_equal(
        pv.cpu().numpy().view(np.uint32),
        v[dec._vn_order_io].astype(np.float32).view(np.uint32))
    np.testing.assert_array_equal(ps.cpu().numpy(),
                                  s[dec._cn_order_io].astype(np.int8))


@pytest.mark.cuda
def test_streamed_copy_and_compute_streams_are_distinct(small_code,
                                                        cuda_device):
    """Three distinct non-default streams; the decode loop runs on the
    compute one, in the worker thread."""
    dec, dyn, chunks, _, _ = _stream_case(small_code, cuda_device)
    copy, compute, readback = dec._cuda_streams()
    handles = {x.cuda_stream for x in (copy, compute, readback)}
    assert len(handles) == 3
    assert torch.cuda.default_stream(cuda_device).cuda_stream not in handles
    seen = set()
    launch = dec._launch

    def spy(*args, **kw):
        seen.add(torch.cuda.current_stream(cuda_device).cuda_stream)
        return launch(*args, **kw)

    dec._launch = spy
    list(dec.decode_streamed(dyn, iter(chunks)))
    assert seen == {compute.cuda_stream}


@pytest.mark.cuda
def test_streamed_worker_failure_fails_the_consumer(small_code, cuda_device):
    """A failure injected into the worker's decode of the second chunk
    reaches the consumer there, after the first chunk's words; nothing
    carries on, the worker is joined and the decoder still decodes."""
    dec, dyn, chunks, ref, edges = _stream_case(small_code, cuda_device)
    launch = dec._launch
    starts = []
    start = dec._start

    def counting_start(*args, **kw):
        starts.append(1)
        return start(*args, **kw)

    def failing(*args, **kw):
        if len(starts) == 2:
            raise RuntimeError("injected worker failure")
        return launch(*args, **kw)

    dec._start, dec._launch = counting_start, failing
    gen = dec.decode_streamed(dyn, iter(chunks), depth=2)
    res, _ = next(gen)
    np.testing.assert_array_equal(res, ref[:edges[1]])
    with pytest.raises(RuntimeError, match="injected worker failure"):
        next(gen)
    assert not _stream_threads()
    dec._start, dec._launch = start, launch
    v, s = chunks[2]
    res, _ = dec.decode(dyn, v.shape[1], v, s)
    np.testing.assert_array_equal(res, ref[edges[2]:edges[3]])


# ---- the rate-0.9 code's shape (d_c = 30) and the qualification script ----

def _fer_stats():
    """scripts/fer_stats_torch.py as a module."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "scripts", "fer_stats_torch.py")
    spec = importlib.util.spec_from_file_location("fer_stats_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.lru_cache(maxsize=None)
def _rate09_small():
    """The BSC rate-0.9 code's base (regular_base(8, 80, 3, 30, seed=3),
    d_c = 30) lifted at Z = 256 by the girth repair, as
    codes/samples.py get_bsc_code lifts it at Z = 12,288."""
    from ldpc_decoder_tpu_torch.codes.protographs import regular_base
    from ldpc_decoder_tpu_torch.codes.qc import (
        make_qc_structure_repair,
        qc_to_code,
    )

    s = make_qc_structure_repair(regular_base(8, 80, 3, 30, seed=3), Z=256,
                                 seed=1)
    return qc_to_code(s), s


@pytest.mark.cuda
def test_rate09_regular_kernels_match_plain(cuda_device):
    """The rate-0.9 shape on a BSC decode state at B = 256 (the
    qualification decoder's pool at p = 0.0058, 4 iterations in): the check
    kernel at d_c = 30 (two lanes a thread), the variable kernel (d_v = 3,
    eight lanes) with emit and fresh lanes, each on both phi policies and
    at its one-lane instantiation, against the plain passes (accurate by
    compare_msgs, fast by compare_msgs_fast; hard bits exact); the parity
    at its run-time degree (30 slots) on the decode state, on the
    codewords and with two checks flipped, vector and one lane: flags
    exact."""
    from ldpc_decoder_tpu_torch.ops import _kernels
    from ldpc_decoder_tpu_torch.rng import chacha_torch as ct
    from ldpc_decoder_tpu_torch.runtime.datagen_device import (
        create_pool_device,
    )

    code, s = _rate09_small()
    dec, ch = _fer_stats().qualification_decoder(code, s, 1, 0.0058,
                                                 cuda_device)
    t, nb = dec.tables, dec.parallel_factor()
    assert isinstance(t, qr.QCRegularTables) and nb == 256
    assert (t.d_c, t.d_v) == (30, 3)
    assert _kernels.lanes_per_thread(nb, torch.bfloat16, 30) == 2
    pool = create_pool_device(dec, ch, 0, nb, chunk_frames=nb)
    llr = dec._lane_llr(pool.values_sorted)
    syn = pool.syn_sorted.view(t.R, t.Z, nb)
    mv, rc = qr.run_iterations_qc_regular(
        qr.init_messages_qc_regular(llr, t, torch.bfloat16), llr, syn, t,
        4)[0]
    pre = qr.PRE_THRESHOLD
    before = dict(_kernels.launch_counts)
    rp = qr.cn_pass_plain(mv, syn, torch.empty_like(rc), t)
    for phi in ("accurate", "fast"):
        rk = qr.cn_pass_regular(mv, syn, torch.empty_like(rc), t, _phi=phi)
        (perf.compare_msgs if phi == "accurate" else perf.compare_msgs_fast)(
            f"r_c {phi}", rk, rp)
    r1 = torch.empty_like(rc)
    with torch.cuda.device(cuda_device):
        _kernels.cn_regular(mv, syn, r1, t, pre, "fast", lanes=1)
    perf.compare_msgs_fast("r_c one lane", r1, rp)
    fresh = torch.arange(nb, device=cuda_device) % 5 == 0
    bp = torch.full((t.C, t.Z, nb), -1, dtype=torch.int8, device=cuda_device)
    mp = qr.vn_pass_plain(rp, llr, mv.clone(), t, bits=bp, fresh=fresh)
    for phi, lanes in (("accurate", None), ("fast", None), ("fast", 1)):
        bk = torch.full_like(bp, -1)
        mk = mv.clone()
        with torch.cuda.device(cuda_device):
            _kernels.vn_regular(rp, llr, mk, bk, fresh, t, pre, phi,
                                lanes=lanes)
        (perf.compare_msgs if phi == "accurate" else perf.compare_msgs_fast)(
            f"msgs_v {phi} lanes {lanes}", mk, mp)
        assert torch.equal(bk, bp), (phi, lanes)
    ref = ct.reference_bits(0, code.n_vars, nb, cuda_device)[
        dec._io_orders[0]].view(t.C, t.Z, nb)
    bad = syn.clone()
    bad[t.R - 1, t.Z - 1, [4, 201]] ^= 1
    for bits, sy, want in ((bp, syn, None), (ref, syn, []),
                           (ref, bad, [4, 201])):
        plain = qr.parity_pass_plain(bits, sy, t)
        assert torch.equal(qr.parity_pass_regular(bits, sy, t), plain)
        one = qr.parity_kernel_flags(bits, sy, t, lanes=1)
        assert torch.equal(one != 0, plain)
        if want is not None:
            assert torch.nonzero(plain).flatten().tolist() == want
    torch.cuda.synchronize()
    counts = {n: _kernels.launch_counts[n] - before[n] for n in (
        "cn_regular", "vn_regular", "parity_regular", "parity_regular_vec",
        "phi_accurate")}
    # 4 iterations x (check, variable, parity) before; then 3 check, 3
    # variable and 6 parity launches
    assert counts == {"cn_regular": 3, "vn_regular": 3, "parity_regular": 6,
                      "parity_regular_vec": 3, "phi_accurate": 2}, counts


@pytest.mark.cuda
def test_rate09_decode_on_card_matches_cpu(cuda_device):
    """A rate-0.9-shaped decode (the base at Z = 256) over the BSC at p =
    0.0058, bfloat16, the qualification decoder's settings (B = 256, k =
    14): the card on the fast phi (the decoder's) against the plain passes
    on the CPU, the same host frames, by the fast-phi decode rule of
    test_general_decode_on_card_matches_cpu: every frame the CPU decodes to
    its reference bits decodes to the same bits on the card, and the
    average iterations are within 5 of the CPU's."""
    from ldpc_decoder_tpu_torch.channels import BSCChannel

    code, s = _rate09_small()
    fer = _fer_stats()
    n = 96
    batch = create_data(code, BSCChannel(0.0058), 0, n, backend="numpy")
    dyn = DynamicParams(num_iter_max=fer.MAX_ITER, num_iter_check_parity=14,
                        loading_factor=2)
    out = {}
    for dev in ("cpu", cuda_device):
        dec, _ = fer.qualification_decoder(code, s, 1, 0.0058, dev)
        assert isinstance(dec.tables, qr.QCRegularTables)
        out[str(dev)] = dec.decode(dyn, n, batch.values, batch.syndromes)
    (res_c, st_c), (res_g, st_g) = out["cpu"], out[str(cuda_device)]
    good = (res_c == batch.ref_bits_packed()).all(axis=1)
    assert good.sum() >= n - 4, int(good.sum())
    np.testing.assert_array_equal(res_g[good], res_c[good])
    assert abs(st_g.avg_iter - st_c.avg_iter) <= 5
    print(f"fast phi: {int((res_g != res_c).any(axis=1).sum())} frames "
          f"differ in words, {int((st_g.iterations != st_c.iterations).sum())}"
          f" in iterations from the CPU's ({int((~good).sum())} frames the "
          f"CPU does not decode)")


@pytest.mark.cuda
def test_fp8_qualify_point_on_card_matches_cpu(small_code, cuda_device):
    """qualify_point(message_dtype="float8_e5m2") on the small p41 (the
    grouped family) at sigma 0.8, 64 frames: the card against the plain
    passes on the CPU, by the fp8 decode rule (equal words: no bit error
    on either side, the same event counts; iterations within one check
    period)."""
    code, s = small_code
    fer = _fer_stats()
    pts = [fer.qualify_point(code, s, 0, 0.8, 64, 0, dev, log=lambda m: None,
                             message_dtype="float8_e5m2")
           for dev in ("cpu", cuda_device)]
    for k in ("frames", "fer1_events", "fer15_events", "bit_errors"):
        assert pts[0][k] == pts[1][k], k
    assert pts[1]["bit_errors"] == 0
    assert abs(pts[0]["avg_iters"] - pts[1]["avg_iters"]) <= 14
    assert abs(pts[0]["max_iters"] - pts[1]["max_iters"]) <= 14


# ---- float8_e5m2 on the general path ------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("B", [64, B_GENERAL, 37])
@pytest.mark.parametrize("phi", ["accurate", "fast"])
def test_general_fp8_kernels_match_plain(cuda_device, phi, B):
    """The general sum-product kernels' float8_e5m2 instantiations (a
    bfloat16 llr) against the plain passes, at B = 64 and 40 (the vector
    instantiations) and the ragged B = 37 (one lane), with and without
    emit, on a state whose large messages make signed zeros (φ of a large
    input rounds to ±0 in e5m2): signs exact, ±0 included; the accurate-φ
    kernels by _fp8_close, the fast ones by the fast rule; hard bits exact.
    Launches counted under the _fp8 names and no other."""
    from ldpc_decoder_tpu_torch.ops import _kernels

    t, st = _general_state(cuda_device, FP8, 12, B)
    big = torch.from_numpy(np.random.default_rng(13).random(
        st["mv"].shape) < 0.2).to(cuda_device)
    st["mv"] = torch.where(big, st["mv"].float() * 16, st["mv"].float()).to(
        FP8)
    held = _fp8_close if phi == "accurate" else functools.partial(
        perf.compare_msgs_fast, "general fp8 fast")
    before = dict(_kernels.launch_counts)
    rk = G.cn_pass_general(st["mv"], st["syn"], torch.empty_like(st["rc"]), t,
                           _phi=phi)
    rp = G.cn_pass_general_plain(st["mv"], st["syn"],
                                 torch.empty_like(st["rc"]), t)
    held(rk, rp)
    zeros = (rk.view(torch.uint8) & 0x7F) == 0
    assert zeros.any() and (rk.view(torch.uint8)[zeros] == 0x80).any()
    for emit in (False, True):
        bk = torch.full((t.n_vars, B), -1, dtype=torch.int8,
                        device=cuda_device)
        bp = bk.clone()
        mk = G.vn_pass_general(st["rc"], st["llr"],
                               torch.empty_like(st["mv"]), t,
                               bits=bk if emit else None, _phi=phi)
        mp = G.vn_pass_general_plain(st["rc"], st["llr"],
                                     torch.empty_like(st["mv"]), t,
                                     bits=bp if emit else None)
        held(mk, mp)
        assert torch.equal(bk, bp)
    torch.cuda.synchronize()
    counts = {n: _kernels.launch_counts[n] - before[n] for n in (
        "cn_general_fp8", "vn_general_fp8", "cn_general", "vn_general")}
    assert counts == {"cn_general_fp8": len(t.cn_buckets),
                      "vn_general_fp8": 2 * len(t.vn_buckets),
                      "cn_general": 0, "vn_general": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("layout", sorted(MINSUM_LAYOUTS))
def test_general_fp8_minsum_kernels_match_plain(cuda_device, layout):
    """The general min-sum kernels' float8_e5m2 instantiations, bitwise,
    with a per-degree α table, an offset (zeros of both signs among the
    outputs) and degree-1 variables and checks, at each layout of
    MINSUM_LAYOUTS; launches counted under the _fp8 names, the check
    kernel's vector ones again under cn_general_minsum_fp8_vec."""
    from ldpc_decoder_tpu_torch.ops import _kernels

    nb, offset = MINSUM_LAYOUTS[layout]
    t, st = _general_state(cuda_device, FP8, 14, nb)
    rng = np.random.default_rng(15)
    st["mv"] = _msgs(rng, st["mv"].shape, FP8, cuda_device)
    st["rc"] = _msgs(rng, st["rc"].shape, FP8, cuda_device)
    if offset:
        st["mv"] = _at_odd_offset(st["mv"])
    alpha = ((1, 0.5), (5, 0.9), (0, 0.75))
    before = dict(_kernels.launch_counts)
    rk = G.cn_pass_general_minsum(st["mv"], st["syn"],
                                  torch.empty_like(st["rc"]), t, alpha, 0.25)
    rp = G.cn_pass_general_minsum_plain(st["mv"], st["syn"],
                                        torch.empty_like(st["rc"]), t,
                                        alpha, 0.25)
    assert _same_bits(rk, rp)
    assert (rk.view(torch.uint8) == 0x80).any()
    for emit in (False, True):
        bk = torch.full((t.n_vars, nb), -1, dtype=torch.int8,
                        device=cuda_device)
        bp = bk.clone()
        mk = G.vn_pass_general_minsum(st["rc"], st["llr"],
                                      torch.empty_like(st["rc"]), t, 20.0,
                                      bits=bk if emit else None)
        mp = G.vn_pass_general_minsum_plain(st["rc"], st["llr"],
                                            torch.empty_like(st["rc"]), t,
                                            20.0, bits=bp if emit else None)
        assert _same_bits(mk, mp)
        assert torch.equal(bk, bp)
    torch.cuda.synchronize()
    counts = {n: _kernels.launch_counts[n] - before[n] for n in (
        "cn_general_minsum_fp8", "cn_general_minsum_fp8_vec",
        "vn_general_minsum_fp8", "cn_general_minsum", "vn_general_minsum")}
    n_cn = len(t.cn_buckets)
    assert counts == {
        "cn_general_minsum_fp8": n_cn,
        "cn_general_minsum_fp8_vec": n_cn if _minsum_vector(layout, FP8)
        else 0,
        "vn_general_minsum_fp8": 2 * len(t.vn_buckets),
        "cn_general_minsum": 0, "vn_general_minsum": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("alg", ["sum-product", "min-sum"])
def test_general_fp8_decode_on_card_matches_cpu(cuda_device, alg,
                                                monkeypatch):
    """A float8_e5m2 decode of a small non-QC (3,6) code, by the rule of
    test_general_decode_on_card_matches_cpu: the kernels on the card
    (sum-product on the accurate φ, bound onto the passes the runners
    call) against the plain passes on the CPU, equal words and per-frame
    iterations; then sum-product on the fast kernels, the decoder's: every
    frame the CPU decodes to the reference bits decodes to the same bits,
    the average iterations within 5. Only float8 general kernels launch."""
    from ldpc_decoder_tpu_torch.ops import _kernels

    code = make_regular_code(512, 3, 6, seed=21)
    ch = BIAWGNChannel(0.72)
    n = 3 * 32 + 8
    batch = create_data(code, ch, 0, n, backend="numpy")
    dyn = DynamicParams(num_iter_max=60, num_iter_check_parity=5)

    def decode(dev):
        dec = LDPCDecoder(code, ch, StaticParams(
            parallel_factor_user=32, qc_autodetect=False,
            message_dtype="float8_e5m2", algorithm=alg), device=dev)
        assert isinstance(dec.tables, G.GeneralTables)
        return dec.decode(dyn, n, batch.values, batch.syndromes)

    res_c, st_c = decode("cpu")
    _kernels.reset_launch_counts()
    with monkeypatch.context() as m:
        if alg == "sum-product":
            for name in ("cn_pass_general", "vn_pass_general"):
                m.setattr(G, name, functools.partial(getattr(G, name),
                                                     _phi="accurate"))
        res_g, st_g = decode(cuda_device)
    launched = {k for k, v in _kernels.launch_counts.items() if v}
    want = ({"cn_general_fp8", "vn_general_fp8", "phi_accurate"}
            if alg == "sum-product" else
            {"cn_general_minsum_fp8", "vn_general_minsum_fp8",
             "cn_general_minsum_fp8_vec"})
    assert launched == want, launched
    np.testing.assert_array_equal(res_g, res_c)
    np.testing.assert_array_equal(st_g.iterations, st_c.iterations)
    ref = batch.ref_bits_packed()
    assert (res_g == ref).all()
    if alg == "min-sum":
        return
    res_f, st_f = decode(cuda_device)
    good = (res_c == ref).all(axis=1)
    np.testing.assert_array_equal(res_f[good], res_c[good])
    assert abs(st_f.avg_iter - st_c.avg_iter) <= 5


# ---- several devices: replicas of one card and gloo processes -----------------

@pytest.mark.cuda
@pytest.mark.parametrize("family", ["grouped", "general"])
def test_decode_sharded_on_card_matches_replica_decodes(small_code,
                                                        cuda_device, family):
    """``decode_sharded`` on a mesh of two replicas of the card: each
    position's words and per-frame iterations equal a ``decode()`` of its
    dealt frames, 0 bit errors; the replicas run on distinct streams."""
    from ldpc_decoder_tpu_torch.parallel.mesh import BatchMesh, deal

    if family == "grouped":
        (code, s), kw = small_code, dict(message_dtype="bfloat16")
    else:
        code, s = make_regular_code(512, 3, 6, seed=21), None
        kw = dict(message_dtype="bfloat16", qc_autodetect=False)
    ch = BIAWGNChannel(0.7)
    n = 2 * 3 * 32 + 5
    batch = create_data(code, ch, 0, n, backend="numpy")
    dyn = DynamicParams(num_iter_max=60, num_iter_check_parity=5)
    dec = LDPCDecoder(code, ch, StaticParams(parallel_factor_user=32, **kw),
                      qc=s, device=cuda_device)
    mesh = BatchMesh((cuda_device, cuda_device))
    res, st = dec.decode_sharded(dyn, n, batch.values, batch.syndromes, mesh)
    assert st.batch_size == 64
    if family == "general":
        assert (res == batch.ref_bits_packed()).all()
    for idx in deal(n, 2):
        real = idx[idx < n]
        r, s_ = dec.decode(dyn, real.size,
                           np.ascontiguousarray(batch.values[:, real]),
                           np.ascontiguousarray(batch.syndromes[:, real]))
        np.testing.assert_array_equal(res[real], r)
        np.testing.assert_array_equal(st.iterations[real], s_.iterations)
    reps = [dec._replica(mesh.devices[0], i) for i in range(2)]
    streams = [rep._cuda_streams() for rep in reps]
    assert len({x.cuda_stream for pair in streams for x in pair}) == 6
    assert reps[0].tables is reps[1].tables is dec.tables


@pytest.mark.cuda
@pytest.mark.parametrize("built_on", ["cuda", "cpu"])
@pytest.mark.parametrize("family", ["grouped", "general"])
def test_decode_sharded_on_mixed_mesh(small_code, cuda_device, family,
                                      built_on):
    """``decode_sharded`` on a mesh of the CPU and the card, by a decoder
    built on either: the position on the other device runs a replica whose
    tables and indices were moved there. Each position's words and
    per-frame iterations equal a ``decode()`` of its dealt frames by a
    decoder built on that position's device."""
    from ldpc_decoder_tpu_torch.parallel.mesh import BatchMesh, deal

    if family == "grouped":
        (code, s), kw = small_code, dict(message_dtype="bfloat16")
    else:
        code, s = make_regular_code(512, 3, 6, seed=21), None
        kw = dict(message_dtype="bfloat16", qc_autodetect=False)
    ch = BIAWGNChannel(0.7)
    n = 2 * 2 * 32 + 5
    batch = create_data(code, ch, 0, n, backend="numpy")
    dyn = DynamicParams(num_iter_max=60, num_iter_check_parity=5)
    on = {kind: LDPCDecoder(code, ch, StaticParams(parallel_factor_user=32,
                                                   **kw),
                            qc=s, device=device)
          for kind, device in (("cpu", "cpu"), ("cuda", cuda_device))}
    dec = on[built_on]
    mesh = BatchMesh(("cpu", cuda_device))
    res, st = dec.decode_sharded(dyn, n, batch.values, batch.syndromes, mesh)
    assert st.batch_size == 64
    for device, idx in zip(mesh.devices, deal(n, 2)):
        real = idx[idx < n]
        r, s_ = on[device.type].decode(
            dyn, real.size, np.ascontiguousarray(batch.values[:, real]),
            np.ascontiguousarray(batch.syndromes[:, real]))
        np.testing.assert_array_equal(res[real], r)
        np.testing.assert_array_equal(st.iterations[real], s_.iterations)
    moved = dec._replica(next(d for d in mesh.devices
                              if d.type != built_on), 0)
    assert moved.device.type != built_on
    for x in (moved.tables.vn_pos, *moved._io_orders, moved._block_perm,
              moved._pack_rows):
        assert x is None or x.device.type == moved.device.type


@pytest.mark.cuda
def test_multiprocess_on_card(cuda_device, tmp_path):
    """Two gloo processes, each one replica of cuda:0, against a
    one-process ``decode_multiprocess`` on a mesh of two replicas of it:
    the same words, frame ids and statistics, 0 bit errors."""
    import json

    from ldpc_decoder_tpu_torch.parallel import dryrun
    from ldpc_decoder_tpu_torch.parallel import multiprocess as mp
    from ldpc_decoder_tpu_torch.parallel.mesh import BatchMesh

    args = ["--code", "small", "--sigma", "0.7", "--lanes", "32", "--dtype",
            "bfloat16", "--k", "5", "--max-iter", "40", "--frames", "133"]
    outs = dryrun.spawn_workers(2, ["--devices", "cuda:0", "--out",
                                    str(tmp_path / "rank{rank}.npz"), *args],
                                timeout=300)
    parsed = mp.worker_parser().parse_args(
        ["--worker", "--init-method", "unused", "--world-size", "1",
         "--rank", "0", *args])
    dec = mp.worker_decoder(parsed, cuda_device)
    res, ids, stats = mp.decode_multiprocess(
        dec, mp.worker_dyn(parsed), 133,
        mesh=BatchMesh((cuda_device, cuda_device)))
    assert stats.bit_errors == 0 and stats.total_supersteps > 2
    for r in range(2):
        assert f"MP_OK rank={r} errors=0" in outs[r], outs[r][-2000:]
        z = np.load(tmp_path / f"rank{r}.npz")
        np.testing.assert_array_equal(z["results"][0], res[r])
        np.testing.assert_array_equal(z["ids"][0], ids[r])
        got = json.loads(str(z["stats"]))
        for name in ("min_iter", "max_iter", "avg_iter", "bit_errors",
                     "frames_with_errors", "frames_above_target",
                     "max_frame_errors", "total_supersteps", "batch_size"):
            assert got[name] == getattr(stats, name), name


# ---- the code-design search ---------------------------------------------------

def _design_code(monkeypatch, cache):
    """scripts/design_code_torch.py as a module, its cache in ``cache``."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "scripts", "design_code_torch.py")
    spec = importlib.util.spec_from_file_location("design_code_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(mod, "CACHE", str(cache))
    return mod


# the recorded 4x7/1p optimum lifted at n = 4096 (m = 3, Z = 192), its
# threshold target 0.8: operating point 0.79
DESIGN_SMALL = ["--rate", "0.5", "--n", "4096", "--coarse", "64",
                "--fine-mod", "8", "--threshold", "0.8"]


@pytest.mark.cuda
def test_measure_point_on_card_matches_cpu(cuda_device, tmp_path,
                                           monkeypatch):
    """design_code_torch's measure_point on its small lift at sigma 0.79,
    64 frames: the card (the grouped kernels, no plain pass) against the
    plain passes on the CPU by the fast-phi decode rule of
    test_general_decode_on_card_matches_cpu (every frame decodes on the
    CPU, so every word is equal; average iterations within 5); the same
    lanes and frames; the record names the card."""
    from ldpc_decoder_tpu_torch.codes.protographs import P41_BASE
    from ldpc_decoder_tpu_torch.ops import _kernels

    dc = _design_code(monkeypatch, tmp_path)
    code, s, _ = dc.lift(P41_BASE.astype(np.int64), 1, 4096, 3, 64, 8,
                         "small.alist")
    cpu = dc.measure_point(code, s, 0.79, 64, "cpu")
    _kernels.reset_launch_counts()
    card = dc.measure_point(code, s, 0.79, 64, cuda_device)
    torch.cuda.synchronize()
    counts = dict(_kernels.launch_counts)
    for name in ("cn", "vn", "parity", "parity_vec"):
        assert counts[name] > 0, name
    assert counts["phi_accurate"] == 0
    assert card["tables"] == cpu["tables"] == "GroupedQCTables"
    assert (card["B"], card["n"]) == (cpu["B"], cpu["n"]) == (256, 64)
    assert cpu["fer1"] == card["fer1"] == 0.0
    np.testing.assert_array_equal(card["results"].cpu().numpy(),
                                  cpu["results"].numpy())
    assert abs(card["avg_iters"] - cpu["avg_iters"]) <= 5
    assert card["max_iters"] <= 120 and card["mbps"] > 0
    assert card["card"]["name"] == torch.cuda.get_device_name(cuda_device)
    assert card["card"]["power_limit"]


@pytest.mark.cuda
def test_design_code_measure_on_card(cuda_device, tmp_path, monkeypatch,
                                     capsys):
    """``design_code_torch.main([... "--measure"])`` on the card (the
    default device): it writes the alist with its #params header and
    prints the summary with the seed's rate, the waterfall at 0.79 and
    0.8 and the card's name and power limit."""
    import json

    from ldpc_decoder_tpu_torch.codes.qc import read_alist_params

    dc = _design_code(monkeypatch, tmp_path)
    assert dc.main(DESIGN_SMALL + ["--frames", "64", "--measure"]) == 0
    out = capsys.readouterr().out
    summary = json.loads(out.strip().splitlines()[-1])
    path = summary["final_alist"]
    assert path == str(tmp_path / "designed_r0.5_t0.8_4x7p1.alist")
    assert read_alist_params(path)["Z"] == "192"
    assert summary["best_seed"] == 3 and summary["mbps_at_op"] > 0
    assert [p["sigma"] for p in summary["waterfall"]] == [0.79, 0.8]
    assert summary["waterfall"][0]["fer1"] == 0.0
    assert all(p["frames"] == 64 for p in summary["waterfall"])
    assert summary["card"]["name"] == torch.cuda.get_device_name(0)
    assert "seed 3: " in out and "waterfall sigma=0.8:" in out
