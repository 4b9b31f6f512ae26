"""The port's protograph copy (``ldpc_decoder_tpu_torch/codes/protographs.py``)
against the JAX package's ``codes/protographs.py``: the checks of
``tests/test_protographs.py`` repeated on the port, each base and lift also
held equal to JAX's for the same seed (exact: both are the same numpy
code), and the lifted codes decoded by the port's decoder on the CPU.
"""

import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from ldpc_decoder_tpu.codes import protographs as jpg  # noqa: E402
from ldpc_decoder_tpu.codes import qc as jqc  # noqa: E402

from ldpc_decoder_tpu_torch.codes import protographs as pg  # noqa: E402
from ldpc_decoder_tpu_torch.codes.qc import (  # noqa: E402
    QCStructure,
    _count_6cycles,
    _has_4cycle,
    make_qc_code,
    make_qc_structure,
)

NAMES = ("AR4JA_RATE_12", "AR4JA_RATE_12_PUNCTURED_COLS", "ar4ja_base",
         "ru_irregular_base", "regular_base", "prelift_base",
         "make_protograph_code_two_stage", "make_protograph_code",
         "P41_BASE", "P41_PUNCTURED_COLS", "p41_code", "p41_shipped_params",
         "OPTIMIZED_R12_BASE")


def _same_structure(s, js):
    assert (s.Z, s.n_base_rows, s.n_base_cols) == (
        js.Z, js.n_base_rows, js.n_base_cols)
    for f in ("edge_row", "edge_col", "edge_shift"):
        np.testing.assert_array_equal(getattr(s, f), getattr(js, f))


def _same_code(code, jcode):
    assert (code.n_vars, code.n_checks, code.n_erased_vars) == (
        jcode.n_vars, jcode.n_checks, jcode.n_erased_vars)
    a, ja = code.to_alist_data(), jcode.to_alist_data()
    for f in ("check_degrees", "var_degrees", "check_adjacency"):
        np.testing.assert_array_equal(getattr(a, f), getattr(ja, f))


def test_every_name_is_copied_with_its_defaults():
    for name in NAMES:
        ours, theirs = getattr(pg, name), getattr(jpg, name)
        if callable(ours):
            assert inspect.signature(ours) == inspect.signature(theirs), name
        elif isinstance(ours, np.ndarray):
            assert ours.dtype == theirs.dtype, name
            np.testing.assert_array_equal(ours, theirs)
        else:
            assert ours == theirs, name


def test_regular_base_degrees():
    b = pg.regular_base(16, 32, 3, 6, seed=1)
    np.testing.assert_array_equal(b, jpg.regular_base(16, 32, 3, 6, seed=1))
    assert (b.sum(axis=0) == 3).all() and (b.sum(axis=1) == 6).all()
    assert b.max() == 1


def test_regular_base_girth8_lift_decodes():
    """The port's rejection lift of a sparse regular base equals JAX's,
    has no 6-cycle, and the port's decoder decodes it (the JAX test's
    B = 8 frames at sigma 0.75)."""
    from ldpc_decoder_tpu_torch.channels import BIAWGNChannel
    from ldpc_decoder_tpu_torch.runtime.datagen import create_data
    from ldpc_decoder_tpu_torch.runtime.decoder import LDPCDecoder
    from ldpc_decoder_tpu_torch.runtime.params import (
        DynamicParams,
        StaticParams,
    )

    base = pg.regular_base(8, 16, 3, 6, seed=3)
    kw = dict(Z=512, seed=1, coarse=128, fine_mod=32, min_girth=8)
    code, s = make_qc_code(base, **kw)
    jcode, js = jqc.make_qc_code(jpg.regular_base(8, 16, 3, 6, seed=3), **kw)
    _same_structure(s, js)
    _same_code(code, jcode)
    assert _count_6cycles(s) == 0
    ch = BIAWGNChannel(0.75)
    dec = LDPCDecoder(code, ch, StaticParams(parallel_factor_user=8), qc=s,
                      device="cpu")
    batch = create_data(code, ch, 0, 8, backend="numpy")
    res, _ = dec.decode(DynamicParams(num_iter_max=50,
                                      num_iter_check_parity=5,
                                      loading_factor=1), 8, batch.values,
                        batch.syndromes)
    assert np.bitwise_count(batch.ref_bits_packed() ^ res).sum() == 0


@pytest.mark.parametrize("seed", [1, 7])
def test_ru_irregular_base_profile(seed):
    b, punct = pg.ru_irregular_base(8, seed=seed)
    jb, jpunct = jpg.ru_irregular_base(8, seed=seed)
    np.testing.assert_array_equal(b, jb)
    assert punct == jpunct == ()
    assert set(np.unique(b.sum(axis=0))) <= {2, 3, 8}
    assert set(np.unique(b.sum(axis=1))) <= {6, 7}
    assert b.shape == (24, 48)


def test_ru_irregular_base_refuses_a_small_scale():
    """At scale 1 no 3 x 6 base realizes the profile: both raise the same
    error."""
    raised = []
    for mod in (pg, jpg):
        with pytest.raises(RuntimeError, match="degree profile") as e:
            mod.ru_irregular_base(1, seed=0)
        raised.append(str(e.value))
    assert raised[0] == raised[1]


def test_ar4ja_base():
    base, punct = pg.ar4ja_base()
    jbase, jpunct = jpg.ar4ja_base()
    np.testing.assert_array_equal(base, jbase)
    assert punct == jpunct == (1,)
    base[0, 0] = 9  # a copy: the module constant stays
    assert pg.AR4JA_RATE_12[0, 0] == 1
    with pytest.raises(ValueError):
        pg.ar4ja_base(2, 3)


def test_ar4ja_multiedge_lift():
    base, _ = pg.ar4ja_base()
    assert base.sum() == 15  # 15 protograph edges incl. parallel ones
    s = make_qc_structure(base, Z=64, seed=2)
    _same_structure(s, jqc.make_qc_structure(jpg.ar4ja_base()[0], Z=64,
                                             seed=2))
    assert s.n_base_edges == 15
    assert not _has_4cycle(s)
    m = (s.edge_row == 0) & (s.edge_col == 1)
    assert m.sum() == 2
    assert len(set(s.edge_shift[m].tolist())) == 2


def test_multiedge_collapse_is_4cycle():
    base, _ = pg.ar4ja_base()
    s = make_qc_structure(base, Z=64, seed=2)
    shifts = s.edge_shift.copy()
    m = np.nonzero((s.edge_row == 0) & (s.edge_col == 1))[0]
    shifts[m[1]] = shifts[m[0]]  # collapse the parallel pair
    bad = QCStructure(Z=s.Z, n_base_rows=s.n_base_rows,
                      n_base_cols=s.n_base_cols, edge_row=s.edge_row,
                      edge_col=s.edge_col, edge_shift=shifts)
    assert _has_4cycle(bad)


def test_two_stage_lift_girth8():
    base, punct = pg.ar4ja_base()
    m = 4
    big = pg.prelift_base(base[:, [0, 2, 3, 4, 1]], m, seed=0)
    np.testing.assert_array_equal(
        big, jpg.prelift_base(base[:, [0, 2, 3, 4, 1]], m, seed=0))
    assert big.shape == (base.shape[0] * m, base.shape[1] * m)
    assert big.max() == 1
    assert big.sum() == base.sum() * m
    kw = dict(m=m, Z=256, seed=3, coarse=64, fine_mod=16)
    code, s = pg.make_protograph_code_two_stage(base, punct, **kw)
    jcode, js = jpg.make_protograph_code_two_stage(base, punct, **kw)
    _same_structure(s, js)
    _same_code(code, jcode)
    assert code.n_vars == base.shape[1] * m * 256
    assert code.n_erased_vars == m * 256
    assert not _has_4cycle(s)
    assert _count_6cycles(s) == 0


@pytest.mark.parametrize("seed", [2, 5])
def test_make_protograph_code_matches_jax(seed):
    """The one-stage lift of AR4JA (multi-edge cells, a punctured column
    moved last) and of p41."""
    for base, punct in (pg.ar4ja_base(),
                        (pg.P41_BASE, pg.P41_PUNCTURED_COLS)):
        kw = dict(Z=64, seed=seed)
        code, s = pg.make_protograph_code(base, punct, **kw)
        jcode, js = jpg.make_protograph_code(base, punct, **kw)
        _same_structure(s, js)
        _same_code(code, jcode)
        assert code.n_erased_vars == len(punct) * 64
        assert not _has_4cycle(s)


def test_two_stage_lift_decodes_end_to_end():
    """The punctured AR4JA two-stage lift decodes through the port's
    grouped family on the CPU below threshold (sigma 0.80 << 0.93), as the
    JAX test decodes it."""
    from ldpc_decoder_tpu_torch.channels import BIAWGNChannel
    from ldpc_decoder_tpu_torch.ops.qc_grouped import GroupedQCTables
    from ldpc_decoder_tpu_torch.runtime.datagen import create_data
    from ldpc_decoder_tpu_torch.runtime.decoder import LDPCDecoder
    from ldpc_decoder_tpu_torch.runtime.params import (
        DynamicParams,
        StaticParams,
    )

    base, punct = pg.ar4ja_base()
    code, s = pg.make_protograph_code_two_stage(
        base, punct, m=4, Z=128, seed=5, coarse=32, fine_mod=8)
    ch = BIAWGNChannel(0.80)
    dec = LDPCDecoder(code, ch, StaticParams(parallel_factor_user=8), qc=s,
                      device="cpu")
    assert isinstance(dec.tables, GroupedQCTables)
    batch = create_data(code, ch, 0, 8, backend="numpy")
    results, _ = dec.decode(DynamicParams(num_iter_max=100,
                                          num_iter_check_parity=10,
                                          loading_factor=1), 8,
                            batch.values, batch.syndromes)
    errors = np.bitwise_count(batch.ref_bits_packed() ^ results).sum(axis=1)
    assert errors.sum() == 0, f"errors: {errors}"


def test_p41_code_shipped_defaults():
    sig = inspect.signature(pg.p41_code)
    assert [p.default for p in sig.parameters.values()] == [
        18432, 3, 8, 1024, 64]
    code, s = pg.p41_code(Z=128, m=4, coarse=64, fine_mod=16)
    assert code.n_vars == 7 * 4 * 128
    assert code.n_erased_vars == 4 * 128
    assert not _has_4cycle(s)
    assert _count_6cycles(s) == 0


def test_optimized_r12_base_profile():
    b = pg.OPTIMIZED_R12_BASE
    assert b.shape == (12, 24)
    assert set(np.unique(b.sum(axis=0))) <= {2, 3, 8}
    assert set(np.unique(b.sum(axis=1))) <= {6, 7}
