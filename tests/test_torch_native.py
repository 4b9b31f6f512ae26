"""The port's native host library against numpy and the JAX package's.

``ldpc_decoder_tpu_torch.native`` builds the port's own copy of the host
C++ source (``ldpc_decoder_tpu_torch/native/src/ldpc_host.cpp``) and binds
the JAX package's five functions under their names. Each is held here to
the port's numpy code and to ``ldpc_decoder_tpu.native`` on the same
inputs, bit for bit; ``create_data`` through the native backend to the
numpy backend (BSC exact, BI-AWGN to the last ulps: libm against numpy's
transcendentals) and to the JAX package's native backend (exact: the same
source built with the same flags).
"""

import os

import numpy as np
import pytest

from ldpc_decoder_tpu import native as jax_native
from ldpc_decoder_tpu.channels import BIAWGNChannel as JaxBIAWGN
from ldpc_decoder_tpu.channels import BSCChannel as JaxBSC
from ldpc_decoder_tpu.codes.code import LDPCCode as JaxLDPCCode
from ldpc_decoder_tpu.runtime.datagen import create_data as jax_create

from ldpc_decoder_tpu_torch import native
from ldpc_decoder_tpu_torch.channels import (
    BIAWGNChannel,
    BSCChannel,
    ErasureChannel,
)
from ldpc_decoder_tpu_torch.codes.code import compute_syndrome
from ldpc_decoder_tpu_torch.codes.generate import make_regular_code
from ldpc_decoder_tpu_torch.codes.protographs import p41_code
from ldpc_decoder_tpu_torch.rng.chacha_np import stream_words
from ldpc_decoder_tpu_torch.runtime import datagen
from ldpc_decoder_tpu_torch.runtime.datagen import create_data

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "ldpc_decoder_tpu_torch")
JAX_SOURCE = os.path.join(REPO, "ldpc_decoder_tpu", "native", "src",
                          "ldpc_host.cpp")
# tests/test_native.py's (seed, start, count) cases
STREAM_CASES = [(0, 0, 64), (12345, 7, 1000), ((77 | 1 << 32), 383, 800)]


@pytest.fixture(scope="module")
def port_lib():
    """The port's library, built at first use (inside a test, not while
    the module is imported)."""
    if not native.available():
        pytest.skip("g++ cannot build the native library")


@pytest.fixture(scope="module")
def both_libs(port_lib):
    if not jax_native.available():
        pytest.skip("g++ cannot build the JAX package's native library")


def _code(name):
    if name == "regular":
        return make_regular_code(256, 3, 6, seed=3)
    return p41_code(Z=32, m=4, coarse=16, fine_mod=8)[0]  # punctured tail


def _channels(kind):
    if kind == "awgn":
        return BIAWGNChannel(0.8), JaxBIAWGN(0.8)
    return BSCChannel(0.05), JaxBSC(0.05)


def test_source_is_the_ports_own():
    """The library builds from a file inside the port, which ships it."""
    src = os.path.realpath(native.SOURCE)
    assert src == os.path.join(os.path.realpath(PORT), "native", "src",
                               "ldpc_host.cpp")
    assert os.path.isfile(src)


def _body(path):
    """The source without its leading comment block."""
    with open(path) as f:
        lines = f.read().splitlines()
    while lines and (lines[0].startswith("//") or not lines[0].strip()):
        lines.pop(0)
    return lines


def test_source_code_matches_the_jax_packages():
    """The copy differs from the JAX package's file only in its leading
    comment, so the two libraries compute the same streams."""
    assert _body(native.SOURCE) == _body(JAX_SOURCE)
    assert len(_body(native.SOURCE)) > 200


@pytest.mark.parametrize("seed,start,count", STREAM_CASES)
def test_stream_words_exact(both_libs, seed, start, count):
    got = native.stream_words(seed, start, count)
    assert got.dtype == np.uint32 and got.shape == (count,)
    np.testing.assert_array_equal(got, stream_words(seed, start, count))
    np.testing.assert_array_equal(
        got, jax_native.stream_words(seed, start, count))


def test_ref_words_layout(both_libs):
    rw = native.gen_ref_words(100, 48, 2)
    # bit b of word [v, g] = bit v of frame 32g+b
    for g in range(2):
        np.testing.assert_array_equal(rw[:, g],
                                      stream_words(100 + 32 * g, 0, 48))
    np.testing.assert_array_equal(rw, jax_native.gen_ref_words(100, 48, 2))


@pytest.mark.parametrize("code_name", ["regular", "p41"])
@pytest.mark.parametrize("kind", ["awgn", "bsc"])
def test_create_data_native(both_libs, code_name, kind):
    """Native against numpy and against the JAX package's native backend
    (start 17, batch 1 of 40 frames: a ragged last group of 32)."""
    code = _code(code_name)
    jcode = JaxLDPCCode.from_alist_data(code.to_alist_data())
    ch, jch = _channels(kind)
    got = create_data(code, ch, 17, 40, batch_index=1, backend="native")
    ref = create_data(code, ch, 17, 40, batch_index=1, backend="numpy")
    jax = jax_create(jcode, jch, 17, 40, batch_index=1, backend="native")
    for name in ("ref_bits", "values", "syndromes"):
        np.testing.assert_array_equal(getattr(got, name), getattr(jax, name))
    np.testing.assert_array_equal(got.ref_bits, ref.ref_bits)
    np.testing.assert_array_equal(got.syndromes, ref.syndromes)
    if kind == "bsc":  # sign flips: exact
        np.testing.assert_array_equal(got.values, ref.values)
    else:  # tests/test_torch_host.py's tolerance
        np.testing.assert_allclose(got.values, ref.values, rtol=5e-5,
                                   atol=2e-5)
    if code.n_erased_vars:
        assert (got.values[-code.n_erased_vars:] == 0).all()


@pytest.mark.parametrize("kind,backend", [
    ("awgn", "native"), ("bsc", "native"), ("erasure", "numpy")])
def test_auto_backend(monkeypatch, kind, backend):
    """``backend="auto"`` takes the native library for BI-AWGN and BSC when
    it builds, as the JAX package does; the erasure channel stays on
    numpy."""
    taken = []
    real = datagen._create_data_native

    def spy(*args):
        taken.append("native")
        return real(*args)
    monkeypatch.setattr(datagen, "_create_data_native", spy)
    ch = {"awgn": BIAWGNChannel(0.8), "bsc": BSCChannel(0.05),
          "erasure": ErasureChannel(0.3)}[kind]
    code = _code("regular")
    got = create_data(code, ch, 0, 32)
    want = backend if native.available() else "numpy"
    assert taken == (["native"] if want == "native" else [])
    ref = create_data(code, ch, 0, 32, backend="numpy")
    np.testing.assert_array_equal(got.ref_bits, ref.ref_bits)
    np.testing.assert_array_equal(got.syndromes, ref.syndromes)


def test_native_refuses_erasure():
    """The JAX package's message, before any library call."""
    with pytest.raises(ValueError, match="supports awgn/bsc channels only"):
        create_data(_code("regular"), ErasureChannel(0.3), 0, 32,
                    backend="native")


def test_add_noise_refuses_a_wrong_output(port_lib):
    rw = native.gen_ref_words(0, 64, 1)
    with pytest.raises(ValueError, match="C-contiguous float32"):
        native.add_noise("bsc", 0.05, 0, rw, 64, 32,
                         np.zeros((64, 32), np.float64))
    with pytest.raises(ValueError, match="too small"):
        native.add_noise("awgn", 0.8, 0, rw, 64, 32,
                         np.zeros((64, 16), np.float32))


def test_syndrome_words_vs_numpy(both_libs):
    code = make_regular_code(512, 3, 6, seed=5)
    rw = native.gen_ref_words(0, code.n_vars, 2)
    args = (code.out_bit_to_edge.astype(np.int64), code.out_edge_to_in_bit)
    syn_w = native.compute_syndrome_words(*args, rw)
    np.testing.assert_array_equal(
        syn_w, jax_native.compute_syndrome_words(*args, rw))
    shifts = np.arange(32, dtype=np.uint32)
    bits = ((rw[:, :, None] >> shifts) & 1).astype(np.int8)
    syn = compute_syndrome(code, bits.reshape(code.n_vars, -1))
    unpacked = ((syn_w[:, :, None] >> shifts) & 1).astype(np.int8)
    np.testing.assert_array_equal(unpacked.reshape(code.n_checks, -1), syn)


@pytest.mark.parametrize("n_words,n_groups", [(96, 3), (50, 1)])
def test_deinterlace_words_roundtrip(both_libs, n_words, n_groups):
    """Frame f = 32g+b, word t, bit i == bit b of interleaved[32t+i, g];
    interleaving the per-frame words again gives the input back."""
    rng = np.random.default_rng(n_words)
    interleaved = rng.integers(0, 2**32, (n_words, n_groups),
                               dtype=np.uint32)
    per_frame = native.deinterlace_words(interleaved)
    n_out = (n_words + 31) // 32
    assert per_frame.shape == (n_groups * 32, n_out)
    np.testing.assert_array_equal(
        per_frame, jax_native.deinterlace_words(interleaved))
    shifts = np.arange(32, dtype=np.uint32)
    # [frames, n_out, 32] bits -> [n_out * 32 words, frames] -> [.., groups]
    bits = (per_frame[:, :, None] >> shifts) & np.uint32(1)
    bits = bits.reshape(n_groups * 32, n_out * 32)[:, :n_words].T
    back = (bits.reshape(n_words, n_groups, 32) << shifts).sum(
        axis=2, dtype=np.uint32)
    np.testing.assert_array_equal(back, interleaved)
