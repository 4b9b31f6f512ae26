"""The QC parity kernels' word algorithm, lane choice and package data.

The CUDA parity kernel (``csrc/parity.cuh``, both QC families) gives each
thread 16 int8 lanes (one 16-byte load per row and slot, four 32-bit
words) or, for a B that is not a multiple of 16 or a base off the 16-byte
boundary, one lane; it XORs the syndrome row and the D rotated rows, ANDs
with 0x01010101, ORs over its rows and sets the flag of each lane whose
bit is set. ``_word_model`` below states that in numpy, operation for
operation, and is held bitwise to the JAX package's Pallas parity passes
(interpret mode, on the CPU) on small codes of both families: on arbitrary
int8 bits and syndromes (negatives included: the sum's parity is the XOR
of the low bits for any two's-complement integers), and on 0/1 words with
chosen checks flipped, at B = 64 (vector), 37 (ragged: one lane) and 64 at
an odd offset (one lane). The port's plain parity passes are held to JAX
on the same arbitrary inputs. The kernels themselves are held to those
plain passes on the card (tests/test_torch_cuda.py).
"""

import fnmatch
import os
import re
import tomllib
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from ldpc_decoder_tpu.codes.protographs import p41_code as jax_p41  # noqa: E402
from ldpc_decoder_tpu.codes.qc import make_qc_code as jax_make_qc  # noqa: E402
from ldpc_decoder_tpu.ops import qc_pallas as jp  # noqa: E402
from ldpc_decoder_tpu.ops import qc_pallas_grouped as jg  # noqa: E402
from ldpc_decoder_tpu.ops.qc_decode import (  # noqa: E402
    QCDecodeTables as JaxQCDecodeTables,
)

from ldpc_decoder_tpu_torch.convert import structure_from_numpy  # noqa: E402
from ldpc_decoder_tpu_torch.ops import _kernels  # noqa: E402
from ldpc_decoder_tpu_torch.ops import qc_grouped as qg  # noqa: E402
from ldpc_decoder_tpu_torch.ops import qc_regular as qr  # noqa: E402
from ldpc_decoder_tpu_torch.ops.qc_decode import QCDecodeTables  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
CSRC = REPO / "ldpc_decoder_tpu_torch" / "csrc"
# (B, at an odd offset): the vector instantiation, a ragged B and an
# offset view, both one lane
LAYOUTS = {"64": (64, False), "37": (37, False),
           "64 at an odd offset": (64, True)}
ROWS = 16  # parity.cuh kRows: rows per thread
LOW = np.uint32(0x01010101)


def _port_tables(js, family):
    s = structure_from_numpy(js.Z, js.n_base_rows, js.n_base_cols,
                             js.edge_row, js.edge_col, js.edge_shift)
    qct = QCDecodeTables.from_structure(s, 0, "cpu")
    if family == "grouped":
        return qg.GroupedQCTables.from_qc_tables(qct)
    return qr.QCRegularTables.from_qc_tables(qct)


@pytest.fixture(scope="module", params=["grouped", "regular"])
def family(request):
    """(name, JAX tables, port tables, JAX parity pass, JAX syndromes)."""
    if request.param == "grouped":
        _, js = jax_p41(Z=32, m=4, coarse=16, fine_mod=8)
        jt = jg.GroupedQCPallasTables.from_qc_tables(
            JaxQCDecodeTables.from_structure(js), 1)
        return ("grouped", jt, _port_tables(js, "grouped"),
                jg.parity_pass_grouped, jg.syndrome_from_bits_qc_grouped)
    _, js = jax_make_qc(np.ones((3, 6), np.int8), Z=64, seed=2)
    jt = jp.QCPallasTables.from_qc_tables(JaxQCDecodeTables.from_structure(js))
    return ("regular", jt, _port_tables(js, "regular"), jp.parity_pass,
            jp.syndrome_from_bits_qc_pallas)


def _checks(name, t):
    """[(syndrome block, [(bits block, shift), ...])] of every check."""
    if name == "grouped":
        out = []
        for g in t.row_groups:
            for n in range(g.count):
                e = range(g.block_start + n * g.degree,
                          g.block_start + (n + 1) * g.degree)
                out.append((g.node_start + n,
                            [(int(t.par_src[i]), int(t.par_shift[i]))
                             for i in e]))
        return out
    read = t.cn_read.numpy()
    return [(r, [(int(c), int(s)) for c, _, s in read[r]])
            for r in range(t.R)]


def _word_model(bits, syn, checks, Z, V):
    """The kernel's arithmetic on [C, Z, B] and [R, Z, B] int8 arrays: per
    thread (check, run of ROWS rows, V lanes) the XOR of the syndrome row
    and the rotated rows as 32-bit words (V = 16; V = 1: one byte), the
    low bit of every lane, OR-ed over the rows into the mask
    m = sum_w (odd_w & 0x01010101) << w, whose bit 8 j + w sets the flag of
    lane 4 w + j. Returns the [B] int32 flags."""
    B = bits.shape[-1]
    flags = np.zeros(B, np.int32)
    if V == 16:
        words = lambda a: a.view(np.uint32)  # noqa: E731  4 lanes a word
        low = LOW
    else:
        words = lambda a: a.view(np.uint8).astype(np.uint32)  # noqa: E731
        low = np.uint32(1)
    n_words = B // 4 if V == 16 else B
    per_thread = V // 4 if V == 16 else 1
    for r, slots in checks:
        z = np.arange(Z)
        acc = words(np.ascontiguousarray(syn[r])).copy()  # [Z, n_words]
        for src, s in slots:
            acc ^= words(np.ascontiguousarray(bits[src][(z + s) % Z]))
        for z0 in range(0, Z, ROWS):
            odd = np.bitwise_or.reduce(acc[z0:z0 + ROWS] & low, axis=0)
            for t0 in range(0, n_words, per_thread):
                m = np.uint32(0)
                for w in range(per_thread):
                    m |= odd[t0 + w] << np.uint32(w)
                lane0 = t0 * 4 if V == 16 else t0
                for bit in range(32):
                    if m >> np.uint32(bit) & np.uint32(1):
                        lane = lane0 + (4 * (bit & 7) + (bit >> 3)
                                        if V == 16 else 0)
                        flags[lane] = 1
    return flags


def _at_odd_offset(x):
    """A copy of ``x`` whose base is one element past an aligned one."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype)
    buf[1:].copy_(x.reshape(-1))
    return buf[1:].view(x.shape)


def _inputs(family, B, data, seed):
    """(bits, syndromes, the violated lanes or None): arbitrary int8 values,
    or 0/1 bits whose syndromes are computed by JAX and then flipped in
    three lanes."""
    name, jt, t, _, jsyn = family
    rng = np.random.default_rng(seed)
    if data == "arbitrary int8":
        bits = rng.integers(-128, 128, (t.C, t.Z, B)).astype(np.int8)
        syn = rng.integers(-128, 128, (t.R, t.Z, B)).astype(np.int8)
        # every third lane even throughout, so it violates no check; the
        # others violate many
        even = np.arange(B) % 3 == 0
        bits[..., even] &= ~np.int8(1)
        syn[..., even] &= ~np.int8(1)
        return bits, syn, None
    bits = (rng.random((t.C, t.Z, B)) < 0.5).astype(np.int8)
    syn = np.asarray(jsyn(jnp.asarray(bits.reshape(-1, B)), jt)).reshape(
        t.R, t.Z, B).copy()
    bad = [0, 5, B - 1]
    syn[t.R - 1, t.Z - 1, bad] ^= 1
    return bits, syn, bad


@pytest.mark.parametrize("data", ["arbitrary int8", "flipped checks"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_word_model_matches_jax(family, layout, data):
    """The kernel's lanes and words against JAX's int32 sums, exactly; the
    instantiation is the one the wrapper picks for the layout."""
    name, jt, t, jpass, _ = family
    B, offset = LAYOUTS[layout]
    bits, syn, bad = _inputs(family, B, data, 31)
    ref = np.asarray(jpass(jnp.asarray(bits), jnp.asarray(syn), jt))
    tb, ts = torch.from_numpy(bits), torch.from_numpy(syn)
    if offset:
        tb, ts = _at_odd_offset(tb), _at_odd_offset(ts)
    lanes, _ = _kernels._parity_launch(B, None, None, tb, ts)
    assert lanes == (16 if B % 16 == 0 and not offset else 1)
    flags = _word_model(bits, syn, _checks(name, t), t.Z, lanes)
    np.testing.assert_array_equal(flags != 0, ref)
    if bad is not None:
        np.testing.assert_array_equal(np.nonzero(flags)[0], bad)
    else:
        np.testing.assert_array_equal(ref, np.arange(B) % 3 != 0)


@pytest.mark.parametrize("B", [64, 37])
def test_plain_parity_matches_jax_on_arbitrary_int8(family, B):
    name, jt, t, jpass, _ = family
    bits, syn, _ = _inputs(family, B, "arbitrary int8", 32)
    ref = np.asarray(jpass(jnp.asarray(bits), jnp.asarray(syn), jt))
    plain = qg.parity_pass_plain if name == "grouped" else qr.parity_pass_plain
    out = plain(torch.from_numpy(bits), torch.from_numpy(syn), t).numpy()
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(ref, np.arange(B) % 3 != 0)


@pytest.mark.parametrize("B,lanes", [(16, 16), (256, 16), (768, 16),
                                     (64, 16), (40, 1), (37, 1), (8, 1),
                                     (1, 1)])
def test_parity_lanes_per_thread(B, lanes):
    assert _kernels.parity_lanes_per_thread(B) == lanes


def test_parity_launch_shape():
    """Lanes from the layout (a base off the 16-byte boundary takes one),
    the slice of PARITY_SLICE_LANES or the one asked for, cut to the power
    of two that holds B and never below the lanes."""
    a = torch.zeros(2 * 256 + 16, dtype=torch.int8)
    bits = a[:256]
    assert _kernels._parity_launch(256, None, None, bits, bits) == (
        16, _kernels.PARITY_SLICE_LANES)
    assert _kernels._parity_launch(256, None, 32, bits, bits) == (16, 32)
    assert _kernels._parity_launch(256, 1, 32, bits, bits) == (1, 32)
    assert _kernels._parity_launch(256, None, 1, bits, bits) == (16, 16)
    assert _kernels._parity_launch(256, None, 4096, bits, bits) == (16, 256)
    assert _kernels._parity_launch(256, None, None, a[1:257],
                                   bits) == (1, min(
                                       256, _kernels.PARITY_SLICE_LANES))
    assert _kernels._parity_launch(256, None, None, bits, a[8:264])[0] == 1
    assert _kernels._parity_launch(256, None, None, bits, a[16:272])[0] == 16
    assert _kernels._parity_launch(37, None, None, bits[:37], bits[:37]) == (
        1, 64)


def test_parity_sources_and_signatures():
    """One template in parity.cuh, hashed into every build key, compiled in
    a source of its own in each QC library; both C entries take the lanes
    and the slice lanes before the stream, both libraries export the lane
    count, and the vector launches have their counters."""
    assert "parity.cuh" in {Path(h).name for h in _kernels.HEADERS}
    for lib, src in (("qc_grouped", "qc_grouped_parity.cu"),
                     ("qc_regular", "qc_regular_parity.cu")):
        assert src in [Path(f).name for f in _kernels.SOURCES[lib]]
        text = (CSRC / src).read_text()
        assert '#include "parity.cuh"' in text
        assert re.search(r"int lanes, int slice_lanes,\s+void\* stream\)",
                         text), src
        sig = _kernels._SIGNATURES[lib]
        assert sig["ldpc_parity_vec_lanes"] == []
    i, p = _kernels._i, _kernels._p
    assert _kernels._SIGNATURES["qc_grouped"]["ldpc_parity_group"][-3:] == [
        i, i, p]
    assert _kernels._SIGNATURES["qc_regular"]["ldpc_parity_regular"][-3:] == [
        i, i, p]
    for name in ("qc_grouped.cu", "qc_regular.cu"):
        text = (CSRC / name).read_text()
        assert "parity_kernel" not in text and "ldpc_parity" not in text
    assert {"parity_vec", "parity_regular_vec"} <= set(_kernels.launch_counts)


def test_package_data_ships_every_kernel_source():
    """An installed port builds its kernels at first use: every source and
    header of the build matches a package-data glob of the port."""
    with open(REPO / "pyproject.toml", "rb") as f:
        data = tomllib.load(f)["tool"]["setuptools"]["package-data"]
    globs = data["ldpc_decoder_tpu_torch"]
    pkg = REPO / "ldpc_decoder_tpu_torch"
    files = [*(f for srcs in _kernels.SOURCES.values() for f in srcs),
             *_kernels.HEADERS]
    assert len(files) > 10
    for f in files:
        rel = os.path.relpath(f, pkg)
        assert any(fnmatch.fnmatch(rel, g) for g in globs), rel
    # and every file of csrc/ is one of them (none ships unbuilt)
    assert {Path(f).name for f in files} == {
        p.name for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh")}


def test_package_data_ships_the_native_source():
    """An installed port builds its host library at first use from its own
    copy of the C++ source: the file lies in the port and matches a
    package-data glob of ``ldpc_decoder_tpu_torch.native``."""
    from ldpc_decoder_tpu_torch import native

    with open(REPO / "pyproject.toml", "rb") as f:
        data = tomllib.load(f)["tool"]["setuptools"]["package-data"]
    pkg = REPO / "ldpc_decoder_tpu_torch" / "native"
    rel = os.path.relpath(native.SOURCE, pkg)
    assert rel == os.path.join("src", "ldpc_host.cpp"), rel
    assert any(fnmatch.fnmatch(rel, g)
               for g in data["ldpc_decoder_tpu_torch.native"]), rel
    assert {p.name for p in (pkg / "src").iterdir()} == {"ldpc_host.cpp"}
