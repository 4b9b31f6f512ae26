"""φ and the BI-AWGN channel: the port against the JAX package.

φ calls tanh and log, whose CPU implementations differ between XLA and
torch by up to ~2e2 float32 ulp (relative 1.74e-5 over 2.2e6 samples of
[1e-5, 80], worst near x = 5, where -log(tanh(x/2)) amplifies tanh's
rounding; torch is within 2.4e-6 of float64 there, XLA within 1.6e-5).
So φ is held to a stated relative tolerance, PHI_RTOL, not bit equality;
everything without a transcendental (LLR conversion, thresholds) is exact.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import importlib  # noqa: E402

import jax.numpy as jnp  # noqa: E402

from ldpc_decoder_tpu.channels import BIAWGNChannel as JaxBIAWGN  # noqa: E402

from ldpc_decoder_tpu_torch.channels import BIAWGNChannel  # noqa: E402

# the modules (ldpc_decoder_tpu.ops re-exports a function named phi)
jphi = importlib.import_module("ldpc_decoder_tpu.ops.phi")
tphi = importlib.import_module("ldpc_decoder_tpu_torch.ops.phi")

# about 3x the largest relative XLA-vs-torch φ difference measured
PHI_RTOL = 5e-5


def _grid():
    x = np.concatenate([
        np.logspace(-5, np.log10(80.0), 4000),
        np.linspace(4.9, 5.1, 2001),  # the branch point and its worst case
        [5.0, np.nextafter(np.float32(5.0), np.float32(0)),
         np.nextafter(np.float32(5.0), np.float32(10)), 6.0, 12.0, 25.0,
         50.0, 80.0, 100.0, 0.0, 1e-7],
    ])
    return x.astype(np.float32)


def test_phi_abs_matches_jax_and_float64():
    x = _grid()
    port = tphi.phi_abs(torch.from_numpy(x)).numpy()
    jx = np.asarray(jphi.phi_abs(jnp.asarray(x)))
    np.testing.assert_allclose(port, jx, rtol=PHI_RTOL, atol=0)
    np.testing.assert_allclose(port, tphi.phi_abs_np(x), rtol=PHI_RTOL,
                               atol=0)
    np.testing.assert_array_equal(tphi.phi_abs_np(x), jphi.phi_abs_np(x))


def test_phi_positive_up_to_80():
    x = torch.from_numpy(_grid())
    assert (tphi.phi_abs(x) > 0).all()
    # 2e^-80 is a normal bfloat16: a saturated message keeps its sign
    assert (tphi.phi_abs(x).to(torch.bfloat16) > 0).all()


def test_signed_phi_keeps_sign_of_zero():
    x = torch.tensor([0.0, -0.0, 3.0, -3.0])
    out = tphi.phi(x)
    np.testing.assert_array_equal(torch.signbit(out).numpy(),
                                  [False, True, False, True])
    ref = np.asarray(jphi.phi(jnp.asarray(x.numpy())))
    np.testing.assert_array_equal(np.signbit(ref), torch.signbit(out).numpy())
    np.testing.assert_allclose(out.numpy(), ref, rtol=PHI_RTOL)


@pytest.mark.parametrize("t", [None, 6.0, 10.0])
def test_infinity_threshold_floor_equal(t):
    assert tphi.pre_from_infinity_threshold(t) == \
        jphi.pre_from_infinity_threshold(t)
    pre = tphi.pre_from_infinity_threshold(t)
    x = _grid()
    np.testing.assert_allclose(
        tphi.phi_abs(torch.from_numpy(x), pre).numpy(),
        np.asarray(jphi.phi_abs(jnp.asarray(x), pre)), rtol=PHI_RTOL)


@pytest.mark.parametrize("sigma", [0.5, 0.87, 0.94, 1.3])
def test_llr_from_channel_exact(sigma):
    rng = np.random.default_rng(7)
    v = (rng.standard_normal(5000) * 2).astype(np.float32)
    port = BIAWGNChannel(sigma).llr_from_channel(torch.from_numpy(v))
    assert port.dtype == torch.float32
    jx = np.asarray(JaxBIAWGN(sigma).llr_from_channel(jnp.asarray(v)))
    np.testing.assert_array_equal(port.numpy(), jx)
    np.testing.assert_array_equal(port.numpy(),
                                  BIAWGNChannel(sigma).llr_np(v))


def test_capacity_and_noise_equal():
    from ldpc_decoder_tpu.rng.chacha_np import PrngChacha as JPrng
    from ldpc_decoder_tpu_torch.rng.chacha_np import PrngChacha

    assert BIAWGNChannel(0.94).capacity() == JaxBIAWGN(0.94).capacity()
    tx = np.where(np.arange(999) % 3, 1.0, -1.0).astype(np.float32)
    a = BIAWGNChannel(0.94).add_noise_np(PrngChacha(11), tx)
    b = JaxBIAWGN(0.94).add_noise_np(JPrng(11), tx)
    np.testing.assert_array_equal(a, b)
