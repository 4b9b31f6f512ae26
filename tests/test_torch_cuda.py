"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU. The
file imports neither JAX nor the JAX package, so it runs on the card's
host, which has no JAX; run it there with the repository's conftest
(which imports JAX) left out:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: signs, hard bits, parity flags and decoded words are exact;
sum-product messages are within one ulp of the storage dtype (the plain
version's φ goes through torch's CUDA tanh/log, the kernel's through
tanhf/logf; float8_e5m2: one e5m2 step on a share of at most 1e-3);
min-sum messages (general and QC, f32, bf16, float8_e5m2 and int8) are
bitwise equal, and min-sum decodes equal in per-frame iterations too. The
kernels' float8_e5m2 store equals torch's conversion on the card and on
the CPU for every bfloat16 input.
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
              torch.int8: torch.int8, torch.float8_e5m2: torch.uint8}[a.dtype]
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8,
                                   torch.float8_e5m2])
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
    cn_k = qg.cn_pass_grouped if mod is qg else qr.cn_pass_regular
    vn_k = qg.vn_pass_grouped if mod is qg else qr.vn_pass_regular
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
    staged (the leave-one-out stages 96 KB of shared memory). Copies, sums
    and stubbed φ bit for bit, live φ by the one-ulp share rule."""
    from ldpc_decoder_tpu_torch import probes
    from ldpc_decoder_tpu_torch.ops import _kernels

    before = dict(_kernels.launch_counts)
    errs = probes.check_template_modes(cuda_device, small=True)
    torch.cuda.synchronize()
    assert len(errs) == 84
    assert _kernels.launch_counts["probe_row_copy"] - before[
        "probe_row_copy"] == 15
    assert _kernels.launch_counts["probe_window"] - before[
        "probe_window"] == 69


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


@pytest.mark.cuda
def test_probe_headlines_on_card(cuda_device):
    """The probe entry point's one-point runs, held against their plain
    versions inside each probe: every probe returns a timed record."""
    from ldpc_decoder_tpu_torch import probes

    for name in ("rotated_copy", "overlap2", "window_read"):
        recs = probes.PROBES[name](cuda_device, small=True, headline=True)
        assert recs and recs[0]["ms"] > 0 and recs[0]["plain_ms"] > 0
        assert recs[0]["max_abs_err"] is not None
