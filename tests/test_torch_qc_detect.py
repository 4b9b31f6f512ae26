"""QC detection on plain alists: the port's copies against the JAX package's.

``detect_qc_structure``, ``detect_qc_structure_permuted``,
``qc_cover_stats`` and ``interleave_code_numbering`` of
``ldpc_decoder_tpu_torch/codes/qc.py`` must return what the JAX package's
return (``tests/test_qc.py``, ``tests/test_qc_permuted.py``) on aligned,
interleaved (both sides and one side) and random codes; the decoder built
from a plain alist must take the family the JAX decoder takes, and an
interleaved alist must decode to the words of its aligned twin.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from ldpc_decoder_tpu.channels import BIAWGNChannel as JaxBIAWGN  # noqa: E402
from ldpc_decoder_tpu.codes import qc as jqc  # noqa: E402
from ldpc_decoder_tpu.codes.generate import (  # noqa: E402
    make_regular_code as jax_make_regular,
)
from ldpc_decoder_tpu.codes.protographs import p41_code as jax_p41  # noqa: E402
from ldpc_decoder_tpu.codes.protographs import (  # noqa: E402
    regular_base as jax_regular_base,
)
from ldpc_decoder_tpu.runtime import params as jparams  # noqa: E402
from ldpc_decoder_tpu.runtime.decoder import (  # noqa: E402
    LDPCDecoder as JaxLDPCDecoder,
)

from ldpc_decoder_tpu_torch.channels import BIAWGNChannel  # noqa: E402
from ldpc_decoder_tpu_torch.codes import qc  # noqa: E402
from ldpc_decoder_tpu_torch.codes.alist import AlistData  # noqa: E402
from ldpc_decoder_tpu_torch.codes.code import LDPCCode  # noqa: E402
from ldpc_decoder_tpu_torch.codes.generate import (  # noqa: E402
    make_regular_code,
)
from ldpc_decoder_tpu_torch.ops.general import GeneralTables  # noqa: E402
from ldpc_decoder_tpu_torch.ops.qc_grouped import GroupedQCTables  # noqa: E402
from ldpc_decoder_tpu_torch.ops.qc_regular import QCRegularTables  # noqa: E402
from ldpc_decoder_tpu_torch.runtime.datagen import create_data  # noqa: E402
from ldpc_decoder_tpu_torch.runtime.decoder import LDPCDecoder  # noqa: E402
from ldpc_decoder_tpu_torch.runtime.params import (  # noqa: E402
    DynamicParams,
    StaticParams,
)


def _port_code(jcode):
    """The same graph as a port LDPCCode (the alist round trip)."""
    return LDPCCode.from_alist_data(AlistData(
        n_checks=jcode.n_checks, n_vars=jcode.n_vars,
        check_degrees=np.diff(jcode.out_bit_to_edge).astype(np.int32),
        var_degrees=np.diff(jcode.in_bit_to_edge).astype(np.int32),
        check_adjacency=jcode.in_edge_to_bit[jcode.edge_out_to_in],
        n_erased_vars=jcode.n_erased_vars))


def _renumber(jcode, to_new_v, to_new_c):
    """``jcode`` with variable a renumbered to_new_v[a], check r to
    to_new_c[r] (a JAX code, so both packages read the same alist)."""
    from ldpc_decoder_tpu.codes.alist import AlistData as JaxAlistData
    from ldpc_decoder_tpu.codes.code import LDPCCode as JaxLDPCCode

    rows = np.repeat(np.arange(jcode.n_checks, dtype=np.int64),
                     np.diff(jcode.out_bit_to_edge))
    cols = jcode.in_edge_to_bit[jcode.edge_out_to_in].astype(np.int64)
    nr, nc = to_new_c[rows], to_new_v[cols]
    order = np.lexsort((nc, nr))
    return JaxLDPCCode.from_alist_data(JaxAlistData(
        n_checks=jcode.n_checks, n_vars=jcode.n_vars,
        check_degrees=np.bincount(nr, minlength=jcode.n_checks).astype(
            np.int32),
        var_degrees=np.bincount(nc, minlength=jcode.n_vars).astype(np.int32),
        check_adjacency=nc[order].astype(np.int32)))


def _aligned():
    base = jax_regular_base(4, 8, 3, 6, seed=5)
    jcode, js = jqc.make_qc_code(base, Z=256, seed=2, coarse=64, fine_mod=16,
                                 min_girth=0)
    return jcode, js


def _codes():
    """name -> (JAX code, detection kwargs)."""
    jcode, js = _aligned()
    Z = js.Z
    a_v = np.arange(jcode.n_vars, dtype=np.int64)
    a_c = np.arange(jcode.n_checks, dtype=np.int64)
    iv = (a_v % Z) * (jcode.n_vars // Z) + a_v // Z
    ic = (a_c % Z) * (jcode.n_checks // Z) + a_c // Z
    small = dict(min_Z=64, require_tile=32)
    return {
        "aligned": (jcode, {}),
        "p41-punctured": (jax_p41(Z=128, m=4, coarse=64, fine_mod=16)[0], {}),
        "interleaved-both": (_renumber(jcode, iv, ic), small),
        "interleaved-variables": (_renumber(jcode, iv, a_c), small),
        "interleaved-checks": (_renumber(jcode, a_v, ic), small),
        "random": (jax_make_regular(1024, 3, 6, seed=5), {}),
    }


CODES = _codes()


def _same_structure(s, js):
    if js is None:
        assert s is None
        return
    assert (s.Z, s.n_base_rows, s.n_base_cols) == (
        js.Z, js.n_base_rows, js.n_base_cols)
    for f in ("edge_row", "edge_col", "edge_shift"):
        np.testing.assert_array_equal(getattr(s, f), getattr(js, f))


@pytest.mark.parametrize("name", sorted(CODES))
def test_detection_matches_jax(name):
    """Aligned and permuted detection return JAX's structure (or None),
    and the permuted one JAX's renumbering."""
    jcode, kw = CODES[name]
    code = _port_code(jcode)
    _same_structure(qc.detect_qc_structure(code, **kw),
                    jqc.detect_qc_structure(jcode, **kw))
    res = qc.detect_qc_structure_permuted(code, **kw)
    jres = jqc.detect_qc_structure_permuted(jcode, **kw)
    assert (res is None) == (jres is None)
    if res is not None:
        _same_structure(res[0], jres[0])
        for a, b in zip(res[1:], jres[1:]):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
    if name.startswith("interleaved"):
        assert qc.detect_qc_structure(code, **kw) is None and res is not None
    if name == "random":
        assert res is None


def test_detection_recovers_the_lift():
    """On the aligned code detection finds the construction's own
    structure (tests/test_qc.py:173)."""
    jcode, js = _aligned()
    s = qc.detect_qc_structure(_port_code(jcode))
    _same_structure(s, js)


def test_interleave_numbering_matches_jax():
    jcode, js = _aligned()
    code, to_v, to_c = qc.interleave_code_numbering(_port_code(jcode), js.Z)
    jcode2, jto_v, jto_c = jqc.interleave_code_numbering(jcode, js.Z)
    np.testing.assert_array_equal(to_v, jto_v)
    np.testing.assert_array_equal(to_c, jto_c)
    for f in ("in_bit_to_edge", "out_bit_to_edge", "in_edge_to_bit",
              "edge_in_to_out"):
        np.testing.assert_array_equal(getattr(code, f), getattr(jcode2, f))
    res = qc.detect_qc_structure_permuted(code, min_Z=64, require_tile=32)
    assert res is not None and res[0].Z == js.Z
    np.testing.assert_array_equal(res[1][to_v], np.arange(code.n_vars))
    np.testing.assert_array_equal(res[2][to_c], np.arange(code.n_checks))


@pytest.mark.parametrize("min_fill", [1.0, 0.875])
def test_cover_stats_match_jax(min_fill):
    for jcode in (_aligned()[0], jax_make_regular(4096, 3, 6, seed=3)):
        assert qc.qc_cover_stats(_port_code(jcode), min_fill=min_fill) == \
            jqc.qc_cover_stats(jcode, min_fill=min_fill)


# (code, StaticParams) -> the family the JAX decoder takes
ROUTES = {
    "regular-sum-product": ("aligned", {}, QCRegularTables),
    "regular-bf16-min-sum": ("aligned", dict(algorithm="min-sum",
                                             message_dtype="bfloat16"),
                             QCRegularTables),
    "regular-int8": ("aligned", dict(algorithm="min-sum",
                                     message_dtype="int8"), GroupedQCTables),
    "p41-min-sum": ("p41-punctured", dict(algorithm="min-sum"),
                    GroupedQCTables),
    "random": ("random", {}, GeneralTables),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_family_from_plain_alist(route):
    """Default detection takes JAX's family: regular for a regular base
    unless the messages are int8, grouped for an irregular base, general
    for a random code."""
    name, kw, want = ROUTES[route]
    jcode, _ = CODES[name]
    dec = LDPCDecoder(_port_code(jcode), BIAWGNChannel(0.7), StaticParams(
        parallel_factor_user=8, **kw), device="cpu")
    assert isinstance(dec.tables, want)
    assert (dec.qc is None) == (want is GeneralTables)
    assert dec.detect_seconds > 0
    jdec = JaxLDPCDecoder(jcode, JaxBIAWGN(0.7), jparams.StaticParams(
        parallel_factor_user=8, **kw))
    if want is GeneralTables:
        assert jdec.qc is None
    else:
        _same_structure(dec.qc, jdec.qc)


@pytest.mark.parametrize("side", ["interleaved-both", "interleaved-variables",
                                  "interleaved-checks"])
@pytest.mark.parametrize("kw", [
    dict(),
    dict(algorithm="min-sum", message_dtype="int8"),
], ids=["sum-product", "int8-min-sum"])
def test_interleaved_decode_matches_aligned(side, kw):
    """An interleaved alist decodes the same physical frames to the words
    of its aligned twin, with equal per-frame iterations; its packing
    gathers rows (the numbering is not a permute of whole blocks)."""
    jcode, _ = _aligned()
    code = _port_code(jcode)
    icode = _port_code(CODES[side][0])
    ch = BIAWGNChannel(0.72)
    sp = StaticParams(parallel_factor_user=16, **kw)
    dyn = DynamicParams(num_iter_max=30, num_iter_check_parity=5)
    n = 40
    batch = create_data(code, ch, 0, n, backend="numpy")
    # the renumbering of each side: aligned index -> interleaved index
    Z, nv, nc = 256, code.n_vars, code.n_checks
    a_v, a_c = np.arange(nv), np.arange(nc)
    to_v = (a_v % Z) * (nv // Z) + a_v // Z if side != \
        "interleaved-checks" else a_v
    to_c = (a_c % Z) * (nc // Z) + a_c // Z if side != \
        "interleaved-variables" else a_c
    vals_i = np.empty_like(batch.values)
    vals_i[to_v] = batch.values
    syn_i = np.empty_like(batch.syndromes)
    syn_i[to_c] = batch.syndromes
    dec_a = LDPCDecoder(code, ch, sp, device="cpu")
    dec_i = LDPCDecoder(icode, ch, StaticParams(
        parallel_factor_user=16, **kw), device="cpu")
    assert dec_i.qc is not None and dec_i.qc.Z == Z
    assert type(dec_i.tables) is type(dec_a.tables)
    # an interleaved variable numbering: the retire's rows are not whole
    # Z-blocks in order
    rows = dec_i._src_row.numpy().reshape(-1, Z)
    in_blocks = bool((rows == rows[:, :1] + np.arange(Z)).all()
                     and (rows[:, 0] % Z == 0).all())
    assert (not in_blocks) == (side != "interleaved-checks")
    res_a, st_a = dec_a.decode(dyn, n, batch.values, batch.syndromes)
    res_i, st_i = dec_i.decode(dyn, n, vals_i, syn_i)

    def unpack(res):
        return np.unpackbits(res.view(np.uint8), bitorder="little",
                             axis=1)[:, :nv]

    np.testing.assert_array_equal(unpack(res_i)[:, to_v], unpack(res_a))
    np.testing.assert_array_equal(st_i.iterations, st_a.iterations)
    assert (res_a == batch.ref_bits_packed()).mean() > 0.9


def test_random_code_takes_general_path_without_detection():
    code = make_regular_code(512, 3, 6, seed=21)
    dec = LDPCDecoder(code, BIAWGNChannel(0.7), StaticParams(
        parallel_factor_user=8, qc_autodetect=False), device="cpu")
    assert isinstance(dec.tables, GeneralTables) and dec.qc is None
    assert dec.detect_seconds == 0.0
