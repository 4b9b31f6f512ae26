"""The port's host-side copies equal the JAX package's originals.

The card's host has no JAX, so ``ldpc_decoder_tpu_torch`` carries JAX-free
copies of the numpy modules (codes, channels, ChaCha8, datagen) and builds
its own copy of the native C++ source. Same seed in, identical arrays out.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from ldpc_decoder_tpu.channels import BIAWGNChannel as JaxBIAWGN  # noqa: E402
from ldpc_decoder_tpu.codes.protographs import p41_code as jax_p41  # noqa: E402
from ldpc_decoder_tpu.runtime.datagen import create_data as jax_create  # noqa: E402

from ldpc_decoder_tpu_torch.channels import BIAWGNChannel  # noqa: E402
from ldpc_decoder_tpu_torch.codes.protographs import (  # noqa: E402
    p41_code,
    p41_shipped_params,
)
from ldpc_decoder_tpu_torch.runtime.datagen import create_data  # noqa: E402

import jax.numpy as jnp  # noqa: E402

from ldpc_decoder_tpu.channels.bsc import BSCChannel as JaxBSC  # noqa: E402
from ldpc_decoder_tpu.channels.erasure import (  # noqa: E402
    ErasureChannel as JaxErasure,
)
from ldpc_decoder_tpu.rng.chacha_np import PrngChacha as JaxPrng  # noqa: E402

from ldpc_decoder_tpu_torch.channels import (  # noqa: E402
    BSCChannel,
    ErasureChannel,
)
from ldpc_decoder_tpu_torch.rng.chacha_np import PrngChacha  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(Z=128, m=4, coarse=64, fine_mod=16)


@pytest.fixture(scope="module")
def codes():
    return jax_p41(**SMALL), p41_code(**SMALL)


def test_p41_structure_identical(codes):
    (jcode, js), (code, s) = codes
    for f in ("edge_row", "edge_col", "edge_shift"):
        np.testing.assert_array_equal(getattr(s, f), getattr(js, f))
    assert (s.Z, s.n_base_rows, s.n_base_cols) == (
        js.Z, js.n_base_rows, js.n_base_cols)
    assert code.n_erased_vars == jcode.n_erased_vars == 4 * 128
    for f in ("in_bit_to_edge", "out_bit_to_edge", "in_edge_to_bit",
              "edge_in_to_out"):
        np.testing.assert_array_equal(getattr(code, f), getattr(jcode, f))


@pytest.mark.parametrize("R,C,dv,dc,seed", [
    (3, 6, 3, 6, 0), (8, 80, 3, 30, 3), (16, 32, 3, 6, 2)])
def test_regular_base_identical(R, C, dv, dc, seed):
    from ldpc_decoder_tpu.codes.protographs import regular_base as jrb
    from ldpc_decoder_tpu_torch.codes.protographs import regular_base

    np.testing.assert_array_equal(regular_base(R, C, dv, dc, seed),
                                  jrb(R, C, dv, dc, seed))


@pytest.mark.parametrize("case", ["small", "reg36"])
def test_make_qc_structure_identical(case):
    """The rejection lift: same shifts for the same seed, on a small base
    and once on the README's regular (3,6) 2^20 code (bench.py's reg36)."""
    from ldpc_decoder_tpu.codes.protographs import regular_base as jrb
    from ldpc_decoder_tpu.codes.qc import make_qc_structure as jmake
    from ldpc_decoder_tpu_torch.codes.qc import make_qc_structure

    if case == "small":
        base, kw = np.ones((3, 6), np.int8), dict(Z=64, seed=1)
    else:
        base = jrb(16, 32, 3, 6, seed=2)
        kw = dict(Z=32768, seed=1, coarse=1024, fine_mod=64, min_girth=8)
    s, js = make_qc_structure(base, **kw), jmake(base, **kw)
    for f in ("edge_row", "edge_col", "edge_shift"):
        np.testing.assert_array_equal(getattr(s, f), getattr(js, f))
    assert (s.Z, s.n_base_rows, s.n_base_cols) == (
        js.Z, js.n_base_rows, js.n_base_cols)


# (port channel, JAX channel) pairs at two noise levels each
CHANNEL_PAIRS = {
    "bsc-0.004": (BSCChannel(0.004), JaxBSC(0.004)),
    "bsc-0.1": (BSCChannel(0.1), JaxBSC(0.1)),
    "erasure-0.4": (ErasureChannel(0.4), JaxErasure(0.4)),
    "erasure-0.1": (ErasureChannel(0.1), JaxErasure(0.1)),
}


@pytest.mark.parametrize("name", sorted(CHANNEL_PAIRS))
def test_bsc_erasure_channels_identical(name):
    """Noise from one ChaCha8 stream, LLRs (BSC keeps the sign of ±0),
    capacity and description: all equal to the JAX package's."""
    ch, jch = CHANNEL_PAIRS[name]
    tx = np.where(np.arange(999) % 3, 1.0, -1.0).astype(np.float32)
    noisy = ch.add_noise_np(PrngChacha(11), tx)
    np.testing.assert_array_equal(noisy, jch.add_noise_np(JaxPrng(11), tx))
    v = np.concatenate([noisy, [0.0, -0.0, 2.5, -2.5]]).astype(np.float32)
    llr = ch.llr_from_channel(torch.from_numpy(v))
    assert llr.dtype == torch.float32
    ref = np.asarray(jch.llr_from_channel(jnp.asarray(v)))
    np.testing.assert_array_equal(llr.numpy(), ref)
    np.testing.assert_array_equal(np.signbit(llr.numpy()), np.signbit(ref))
    np.testing.assert_array_equal(ch.llr_np(v), jch.llr_np(v))
    assert ch.capacity() == jch.capacity()
    assert ch.description() == jch.description()
    assert ch.channel_type == jch.channel_type


def test_shipped_params_match():
    from ldpc_decoder_tpu.codes.protographs import p41_shipped_params as jp

    assert p41_shipped_params() == jp()


def test_alist_round_trip_keeps_params(codes, tmp_path):
    from ldpc_decoder_tpu.codes.qc import load_qc_alist as jax_load
    from ldpc_decoder_tpu_torch.codes.qc import (
        load_qc_alist,
        read_alist_params,
        write_qc_alist,
    )

    _, (code, s) = codes
    path = str(tmp_path / "p41_small.alist")
    params = {**p41_shipped_params(), "Z": "128", "m": "4"}
    write_qc_alist(code, s, path, params=params)
    assert read_alist_params(path) == params
    code2, s2 = load_qc_alist(path)
    np.testing.assert_array_equal(code2.edge_in_to_out, code.edge_in_to_out)
    np.testing.assert_array_equal(s2.edge_shift, s.edge_shift)
    assert code2.n_erased_vars == code.n_erased_vars
    # the JAX package reads the port's cache file identically
    jcode, js = jax_load(path)
    np.testing.assert_array_equal(jcode.edge_in_to_out, code.edge_in_to_out)
    np.testing.assert_array_equal(js.edge_shift, s.edge_shift)


def _golden_cases():
    with open(os.path.join(REPO, "tests", "data", "chacha_golden.txt")) as f:
        for line in f:
            seed, iv, first, last = line.split()
            yield int(seed), int(iv), bytes.fromhex(first), bytes.fromhex(last)


@pytest.mark.parametrize("seed,iv,first,last", list(_golden_cases()))
def test_chacha_words_match_golden(seed, iv, first, last):
    from ldpc_decoder_tpu_torch.rng.chacha_np import (
        BLOCKS_PER_REFILL,
        WORDS_PER_REFILL,
        stream_words,
    )

    assert stream_words(seed, WORDS_PER_REFILL * iv, 16).tobytes() == first
    assert stream_words(
        seed, WORDS_PER_REFILL * iv + 16 * (BLOCKS_PER_REFILL - 1), 16
    ).tobytes() == last


def test_create_data_numpy_identical(codes):
    (jcode, _), (code, _) = codes
    a = jax_create(jcode, JaxBIAWGN(0.8), 5, 8, backend="numpy")
    b = create_data(code, BIAWGNChannel(0.8), 5, 8, backend="numpy")
    np.testing.assert_array_equal(b.ref_bits, a.ref_bits)
    np.testing.assert_array_equal(b.values, a.values)
    np.testing.assert_array_equal(b.syndromes, a.syndromes)
    assert (b.values[-code.n_erased_vars:] == 0).all()


def test_create_data_native_equals_numpy(codes):
    from ldpc_decoder_tpu_torch import native

    if not native.available():
        pytest.skip("g++ cannot build the native library here")
    _, (code, _) = codes
    ch = BIAWGNChannel(0.9)
    a = create_data(code, ch, 40, 40, backend="numpy")
    b = create_data(code, ch, 40, 40, backend="native")
    np.testing.assert_array_equal(b.ref_bits, a.ref_bits)
    np.testing.assert_array_equal(b.syndromes, a.syndromes)
    # same draws; libm vs numpy log/sqrt differ in the last ulps (the
    # tolerance of the JAX package's tests/test_native.py)
    np.testing.assert_allclose(b.values, a.values, rtol=5e-5, atol=2e-5)


GENERATED = {
    "regular": ("make_regular_code", (512, 3, 6), dict(seed=9)),
    "irregular": ("make_irregular_code",
                  (400, 200, {1: 0.05, 2: 0.35, 3: 0.4, 4: 0.2},
                   {5: 0.5, 6: 0.5}), dict(seed=3)),
}


@pytest.mark.parametrize("name", sorted(GENERATED))
def test_generate_and_compile_identical(name):
    """The same seed gives the identical adjacency, and compile_code the
    identical tables, array by array."""
    from ldpc_decoder_tpu.codes import compiled as jcompiled
    from ldpc_decoder_tpu.codes import generate as jgenerate
    from ldpc_decoder_tpu_torch.codes import compiled, generate

    fn, args, kw = GENERATED[name]
    jcode = getattr(jgenerate, fn)(*args, **kw)
    code = getattr(generate, fn)(*args, **kw)
    for f in ("in_bit_to_edge", "out_bit_to_edge", "in_edge_to_bit",
              "out_edge_to_bit", "edge_in_to_out", "edge_out_to_in"):
        np.testing.assert_array_equal(getattr(code, f), getattr(jcode, f))
    jcc, cc = jcompiled.compile_code(jcode), compiled.compile_code(code)
    for f in ("vn_order", "vn_pos", "cn_order", "cn_pos", "perm_v2c",
              "perm_c2v", "cn_edge_vnrow"):
        np.testing.assert_array_equal(getattr(cc, f), getattr(jcc, f))
    for side in ("vn_buckets", "cn_buckets"):
        assert ([vars(b) for b in getattr(cc, side)]
                == [vars(b) for b in getattr(jcc, side)])


def test_make_regular_code_rejects_bad_degrees():
    from ldpc_decoder_tpu_torch.codes.generate import make_regular_code

    with pytest.raises(ValueError, match="divisible"):
        make_regular_code(10, 3, 7)


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import ldpc_decoder_tpu_torch.runtime.decoder\n"
        "import ldpc_decoder_tpu_torch.runtime.datagen\n"
        "import ldpc_decoder_tpu_torch.convert\n"
        "import ldpc_decoder_tpu_torch.ops.qc_regular\n"
        "import ldpc_decoder_tpu_torch.ops.qc_grouped\n"
        "import ldpc_decoder_tpu_torch.codes.qc\n"
        "import ldpc_decoder_tpu_torch.ops.general\n"
        "import ldpc_decoder_tpu_torch.codes.generate\n"
        "import ldpc_decoder_tpu_torch.codes.compiled\n"
        "import ldpc_decoder_tpu_torch.channels.bsc\n"
        "import ldpc_decoder_tpu_torch.channels.erasure\n"
        "import ldpc_decoder_tpu_torch.cli\n"
        "import ldpc_decoder_tpu_torch.runtime.harness\n"
        "import ldpc_decoder_tpu_torch.runtime.report\n"
        "import ldpc_decoder_tpu_torch.runtime.smoke\n"
        "import ldpc_decoder_tpu_torch.runtime.perf\n"
        "import ldpc_decoder_tpu_torch.probes\n"
        "import ldpc_decoder_tpu_torch.probes.__main__\n"
        "import ldpc_decoder_tpu_torch.rng.chacha_torch\n"
        "import ldpc_decoder_tpu_torch.runtime.datagen_device\n"
        "import ldpc_decoder_tpu_torch.codes.samples\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'ldpc_decoder_tpu' or m.startswith('ldpc_decoder_tpu.')]\n"
        "assert not bad, bad\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_build_shared_library_several_sources(tmp_path, monkeypatch):
    """A library of several sources (the grouped kernels' two): each source
    compiled to an object, then linked into one library that exports both
    sources' functions; the compilers' output kept in the log; a changed
    source rebuilds."""
    import ctypes
    import shutil

    from ldpc_decoder_tpu_torch import _build

    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    a, b = tmp_path / "a.cpp", tmp_path / "b.cpp"
    a.write_text('extern "C" int two() { return 2; }\n')
    b.write_text('extern "C" int three() { return 3; }\n'
                 '#warning from-b\n')
    cmd = ["g++", "-O1", "-shared", "-fPIC"]
    path = _build.build_shared_library("t", [str(a), str(b)], cmd, 120)
    lib = ctypes.CDLL(path)
    assert (lib.two(), lib.three()) == (2, 3)
    assert "from-b" in open(path + ".log").read()
    assert sorted(os.listdir(tmp_path / "build")) == sorted(
        [os.path.basename(path), os.path.basename(path) + ".log"])
    assert _build.build_shared_library("t", [str(a), str(b)], cmd,
                                       120) == path
    b.write_text('extern "C" int three() { return 4; }\n')
    path2 = _build.build_shared_library("t", [str(a), str(b)], cmd, 120)
    assert path2 != path and ctypes.CDLL(path2).three() == 4
    b.write_text("syntax error\n")
    with pytest.raises(_build.BuildError):
        _build.build_shared_library("t", [str(a), str(b)], cmd, 120)
