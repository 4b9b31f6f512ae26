"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU. The
file imports neither JAX nor the JAX package, so it runs on the card's
host, which has no JAX; run it there with the repository's conftest
(which imports JAX) left out:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: signs, hard bits, parity flags and decoded words are exact;
sum-product messages are within one ulp of the storage dtype (the plain
version's φ goes through torch's CUDA tanh/log, the kernel's through
tanhf/logf); min-sum messages (general and QC, f32, bf16 and int8) are
bitwise equal, and min-sum decodes equal in per-frame iterations too.
"""

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

    rk = qg.cn_pass_grouped(mv, syn, rc.clone(), t)
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
                                include_d1=d1)
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

    rk = qr.cn_pass_regular(mv, syn, rc.clone(), t)
    rp = qr.cn_pass_plain(mv, syn, rc.clone(), t)
    assert torch.equal(torch.signbit(rk), torch.signbit(rp))
    torch.testing.assert_close(rk.float(), rp.float(), rtol=ulp, atol=0)

    for emit, fr in [(False, None), (True, fresh), (False, fresh)]:
        bk = torch.full((t.C, t.Z, B), -1, dtype=torch.int8,
                        device=cuda_device)
        bp = bk.clone()
        mk = qr.vn_pass_regular(rc, llr, mv.clone(), t,
                                bits=bk if emit else None, fresh=fr)
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
                    ("parity_regular", 1)):
        assert _kernels.launch_counts[name] - before[name] == n


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


def _general_state(device, dtype, seed):
    t = G.GeneralTables.from_compiled(compile_code(
        make_irregular_code(*IRREGULAR[0], **IRREGULAR[1])), device)
    rng = np.random.default_rng(seed)
    nb = B_GENERAL

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
              torch.int8: torch.int8}[a.dtype]
    return torch.equal(a.view(as_int), b.view(as_int))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_general_kernels_match_plain(cuda_device, dtype):
    from ldpc_decoder_tpu_torch.ops import _kernels

    t, st = _general_state(cuda_device, dtype, 7)
    ulp = 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -22
    before = dict(_kernels.launch_counts)
    rk = G.cn_pass_general(st["mv"], st["syn"], torch.empty_like(st["rc"]), t)
    rp = G.cn_pass_general_plain(st["mv"], st["syn"],
                                 torch.empty_like(st["rc"]), t)
    assert torch.equal(torch.signbit(rk), torch.signbit(rp))
    torch.testing.assert_close(rk.float(), rp.float(), rtol=ulp, atol=0)
    for emit in (False, True):
        bk = torch.full((t.n_vars, B_GENERAL), -1, dtype=torch.int8,
                        device=cuda_device)
        bp = bk.clone()
        mk = G.vn_pass_general(st["rc"], st["llr"], torch.empty_like(st["mv"]),
                               t, bits=bk if emit else None)
        mp = G.vn_pass_general_plain(st["rc"], st["llr"],
                                     torch.empty_like(st["mv"]), t,
                                     bits=bp if emit else None)
        assert torch.equal(torch.signbit(mk), torch.signbit(mp))
        torch.testing.assert_close(mk.float(), mp.float(), rtol=ulp, atol=0)
        assert torch.equal(bk, bp)
    torch.cuda.synchronize()
    assert (_kernels.launch_counts["cn_general"] - before["cn_general"]
            == len(t.cn_buckets))
    assert (_kernels.launch_counts["vn_general"] - before["vn_general"]
            == 2 * len(t.vn_buckets))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_general_minsum_kernels_match_plain(cuda_device, dtype):
    """Bitwise, with a per-degree α table (the degree-1 checks have their
    own), an offset, and degree-1 variables and checks."""
    from ldpc_decoder_tpu_torch.ops import _kernels

    t, st = _general_state(cuda_device, dtype, 8)
    alpha = ((1, 0.5), (5, 0.9), (0, 0.75))
    before = dict(_kernels.launch_counts)
    rk = G.cn_pass_general_minsum(st["mv"], st["syn"],
                                  torch.empty_like(st["rc"]), t, alpha, 0.25)
    rp = G.cn_pass_general_minsum_plain(st["mv"], st["syn"],
                                        torch.empty_like(st["rc"]), t,
                                        alpha, 0.25)
    assert _same_bits(rk, rp)
    for emit in (False, True):
        bk = torch.full((t.n_vars, B_GENERAL), -1, dtype=torch.int8,
                        device=cuda_device)
        bp = bk.clone()
        mk = G.vn_pass_general_minsum(st["rc"], st["llr"],
                                      torch.empty_like(st["mv"]), t, 20.0,
                                      bits=bk if emit else None)
        mp = G.vn_pass_general_minsum_plain(st["rc"], st["llr"],
                                            torch.empty_like(st["mv"]), t,
                                            20.0, bits=bp if emit else None)
        assert _same_bits(mk, mp)
        assert torch.equal(bk, bp)
    torch.cuda.synchronize()
    counts = {n: _kernels.launch_counts[n] - before[n]
              for n in ("cn_general_minsum", "vn_general_minsum")}
    assert counts == {"cn_general_minsum": len(t.cn_buckets),
                      "vn_general_minsum": 2 * len(t.vn_buckets)}


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [
    dict(message_dtype="float32"),
    dict(message_dtype="int8", algorithm="min-sum", minsum_alpha=0.8,
         minsum_offset=0.0),
])
def test_general_decode_on_card_matches_cpu(cuda_device, kw):
    """The general path on a small (3,6) code: kernels on the card vs
    plain passes on the CPU; equal words and per-frame iterations."""
    code = make_regular_code(512, 3, 6, seed=21)
    ch = BIAWGNChannel(0.72)
    n = 3 * 32 + 8
    batch = create_data(code, ch, 0, n, backend="numpy")
    dyn = DynamicParams(num_iter_max=60, num_iter_check_parity=5)
    out = {}
    for dev in ("cpu", cuda_device):
        dec = LDPCDecoder(code, ch, StaticParams(
            parallel_factor_user=32, qc_autodetect=False, **kw), device=dev)
        assert isinstance(dec.tables, G.GeneralTables)
        out[str(dev)] = dec.decode(dyn, n, batch.values, batch.syndromes)
    (res_c, st_c), (res_g, st_g) = out["cpu"], out[str(cuda_device)]
    np.testing.assert_array_equal(res_g, res_c)
    np.testing.assert_array_equal(st_g.iterations, st_c.iterations)
    assert (res_g == batch.ref_bits_packed()).all()


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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_grouped_minsum_kernels_match_plain(cuda_device, dtype):
    """Every degree 1..32 on both sides (so degree 1 and 17-32 too), B = 40
    (the last lane chunk guarded), an α table with an offset, fresh lanes
    (for int8 the lane reset writes quantize(clip(llr))): bitwise."""
    from ldpc_decoder_tpu_torch.ops import _kernels

    t = qg.GroupedQCTables.from_qc_tables(QCDecodeTables.from_structure(
        _staircase_structure(32, 16, 3), 0, cuda_device))
    assert [g.degree for g in t.row_groups] == list(range(1, 33))
    assert [g.degree for g in t.col_groups] == list(range(1, 33))
    rng = np.random.default_rng(9)
    nb = B_GENERAL
    mv = _msgs(rng, (t.nb, t.Z, nb), dtype, cuda_device)
    rc = _msgs(rng, (t.nb, t.Z, nb), dtype, cuda_device)
    llr = torch.from_numpy((rng.standard_normal((t.C, t.Z, nb)) * 12).astype(
        np.float32)).to(cuda_device, G.llr_dtype(dtype))
    syn = torch.from_numpy((rng.random((t.R, t.Z, nb)) < 0.5).astype(
        np.int8)).to(cuda_device)
    fresh = torch.from_numpy(rng.random(nb) < 0.5).to(cuda_device)
    alpha = ((1, 0.5), (17, 0.9), (32, 0.625), (0, 0.75))
    before = dict(_kernels.launch_counts)
    rk = qg.cn_pass_grouped_minsum(mv, syn, torch.empty_like(rc), t, alpha,
                                   0.25)
    rp = qg.cn_pass_minsum_plain(mv, syn, torch.empty_like(rc), t, alpha,
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
              for n in ("cn_group_minsum", "vn_group_minsum")}
    # non-emit skips the degree-1 group; emit and include_d1 run it
    assert counts == {"cn_group_minsum": 32, "vn_group_minsum": 3 * 32 - 1}


@pytest.mark.cuda
@pytest.mark.parametrize("d_c", [6, 30])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_regular_minsum_kernels_match_plain(cuda_device, dtype, d_c):
    from ldpc_decoder_tpu_torch.ops import _kernels

    t = qr.QCRegularTables.from_qc_tables(QCDecodeTables.from_structure(
        _regular_structure(d_c, 96, d_c), 0, cuda_device))
    rng = np.random.default_rng(10)
    nb = B_GENERAL
    mv = _msgs(rng, (t.C, t.d_v, t.Z, nb), dtype, cuda_device)
    rc = _msgs(rng, (t.R, t.d_c, t.Z, nb), dtype, cuda_device)
    llr = torch.from_numpy((rng.standard_normal((t.C, t.Z, nb)) * 12).astype(
        np.float32)).to(cuda_device, dtype)
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
