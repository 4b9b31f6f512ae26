"""``ldpc_decoder_tpu_torch/codes/samples.py`` ``get_bsc_code``: the BSC
rate-0.9 sample code equals the JAX construction of
``scripts/make_sample_codes.py`` at full size (n = 983,040; exact), and its
alist cache round-trips under its ``#params`` header; a cache without the
header (as ``make_sample_codes.py`` writes it) is rebuilt.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ldpc_decoder_tpu.codes import qc as jqc  # noqa: E402
from ldpc_decoder_tpu.codes.protographs import (  # noqa: E402
    regular_base as jax_regular_base,
)

from ldpc_decoder_tpu_torch.codes import samples  # noqa: E402
from ldpc_decoder_tpu_torch.codes.protographs import (  # noqa: E402
    regular_base,
)
from ldpc_decoder_tpu_torch.codes.qc import (  # noqa: E402
    load_qc_alist,
    read_alist_params,
)


@pytest.fixture(scope="module")
def jax_bsc():
    """scripts/make_sample_codes.py:89-94 with the JAX package."""
    base = jax_regular_base(8, 80, 3, 30, seed=3)
    s = jqc.make_qc_structure_repair(base, Z=12288, seed=1, coarse=1024,
                                     fine_mod=64)
    return base, s, jqc.qc_to_code(s)


@pytest.fixture
def cache(tmp_path, monkeypatch):
    path = tmp_path / "code_bsc_rate_0.9_thr_0.007.alist"
    monkeypatch.setattr(samples, "BSC_ALIST", str(path))
    return path


def _body(path):
    """The file's lines after its #params header (the QC header and the
    alist)."""
    return [ln for ln in path.read_text().splitlines()
            if not ln.startswith("#params=")]


def test_bsc_code_equals_the_jax_construction(jax_bsc, cache, tmp_path):
    jbase, js, jcode = jax_bsc
    np.testing.assert_array_equal(regular_base(8, 80, 3, 30, seed=3), jbase)
    code, s, how = samples.get_bsc_code()
    assert how == "built"
    assert (s.Z, s.n_base_rows, s.n_base_cols) == (12288, 8, 80)
    for f in ("edge_row", "edge_col", "edge_shift"):
        np.testing.assert_array_equal(getattr(s, f), getattr(js, f))
    assert (code.n_vars, code.n_checks, code.n_edges, code.n_erased_vars) \
        == (983040, 98304, 2949120, 0)
    assert (code.n_vars, code.n_checks, code.n_edges) == (
        jcode.n_vars, jcode.n_checks, jcode.n_edges)
    # the alist: the JAX script's file (no header) is this one's body
    jpath = tmp_path / "jax.alist"
    jqc.write_qc_alist(jcode, js, str(jpath))
    assert _body(cache) == jpath.read_text().splitlines()
    assert read_alist_params(str(cache)) == samples.BSC_PARAMS


def test_bsc_cache_round_trips_and_a_headerless_one_is_rebuilt(jax_bsc,
                                                               cache):
    code, s, how = samples.get_bsc_code()
    assert how == "built"
    code2, s2, how2 = samples.get_bsc_code()
    assert how2 == "cache"
    for f in ("edge_row", "edge_col", "edge_shift"):
        np.testing.assert_array_equal(getattr(s2, f), getattr(s, f))
    np.testing.assert_array_equal(code2.to_alist_data().check_adjacency,
                                  code.to_alist_data().check_adjacency)
    # make_sample_codes.py's file: the same code, no #params header
    _, js, jcode = jax_bsc
    jqc.write_qc_alist(jcode, js, str(cache))
    assert read_alist_params(str(cache)) is None
    _, s3, how3 = samples.get_bsc_code()
    assert how3 == "built"
    assert read_alist_params(str(cache)) == samples.BSC_PARAMS
    np.testing.assert_array_equal(s3.edge_shift, s.edge_shift)
    # a header naming another construction is rebuilt too
    text = cache.read_text().replace("seed=1", "seed=2", 1)
    cache.write_text(text)
    assert samples.get_bsc_code()[2] == "built"
    c4, s4 = load_qc_alist(str(cache))
    np.testing.assert_array_equal(s4.edge_shift, s.edge_shift)
    assert c4.n_vars == 983040
