"""The port's P-EXIT copy (``ldpc_decoder_tpu_torch/codes/pexit.py``)
against the JAX package's ``codes/pexit.py``, on the inputs of
``tests/test_pexit.py``, and that file's own assertions repeated on the
port.

Tolerances: both are the same numpy code, so J, J_inv and the convergence
MIs agree within 1e-12 and the thresholds and sampled-DE runs (bisections
and seeded Monte-Carlo over identical floats) exactly.
"""

import numpy as np
import pytest

from ldpc_decoder_tpu.codes import pexit as jpx
from ldpc_decoder_tpu.codes.protographs import P41_BASE as JAX_P41
from ldpc_decoder_tpu.codes.protographs import ar4ja_base as jax_ar4ja
from ldpc_decoder_tpu.codes.protographs import regular_base as jax_regular

from ldpc_decoder_tpu_torch.codes import pexit as px
from ldpc_decoder_tpu_torch.codes.protographs import (
    P41_BASE,
    ar4ja_base,
    regular_base,
)

XS = np.linspace(0.05, 6.0, 60)
PROTO36 = np.full((1, 2), 3)  # the (3,6) protograph


def test_names_and_defaults_match():
    import inspect

    for name in ("J", "J_inv", "pexit_converges", "pexit_threshold",
                 "minsum_de_run", "minsum_de_threshold"):
        assert (inspect.signature(getattr(px, name))
                == inspect.signature(getattr(jpx, name))), name


def test_j_and_j_inv_match_jax():
    np.testing.assert_allclose(px.J(XS), jpx.J(XS), rtol=0, atol=1e-12)
    i = np.linspace(0.0, 1.0, 101)
    np.testing.assert_allclose(px.J_inv(i), jpx.J_inv(i), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(px.J_inv(px.J(XS)), jpx.J_inv(jpx.J(XS)),
                               rtol=0, atol=1e-12)


def test_j_roundtrip():
    assert np.abs(px.J_inv(px.J(XS)) - XS).max() < 0.1


@pytest.mark.parametrize("sigma", [0.80, 0.88, 0.95])
def test_pexit_converges_matches_jax(sigma):
    base = regular_base(4, 8, 3, 6, seed=1)
    b, punct = ar4ja_base()
    assert px.pexit_converges(base, sigma) == jpx.pexit_converges(
        jax_regular(4, 8, 3, 6, seed=1), sigma)
    assert px.pexit_converges(b, sigma, punct) == jpx.pexit_converges(
        jax_ar4ja()[0], sigma, jax_ar4ja()[1])


def test_regular_36_threshold():
    base = regular_base(4, 8, 3, 6, seed=1)
    thr = px.pexit_threshold(base)
    assert thr == jpx.pexit_threshold(jax_regular(4, 8, 3, 6, seed=1))
    assert abs(thr - 0.879) < 0.01


def test_ar4ja_threshold():
    base, punct = ar4ja_base()
    thr = px.pexit_threshold(base, punct)
    assert thr == jpx.pexit_threshold(*jax_ar4ja())
    assert abs(thr - 0.93) < 0.015


def test_iteration_constrained_threshold_is_lower():
    base = regular_base(4, 8, 3, 6, seed=1)
    thr_inf = px.pexit_threshold(base, max_iters=2000)
    thr_40 = px.pexit_threshold(base, max_iters=40)
    jbase = jax_regular(4, 8, 3, 6, seed=1)
    assert thr_inf == jpx.pexit_threshold(jbase, max_iters=2000)
    assert thr_40 == jpx.pexit_threshold(jbase, max_iters=40)
    assert thr_40 < thr_inf


def test_p41_constrained_threshold_matches_jax():
    """eval_proto's score: p41's P-EXIT threshold at 80 iterations."""
    kw = dict(lo=0.7, hi=1.0, tol=1e-3, max_iters=80)
    thr = px.pexit_threshold(P41_BASE, (6,), **kw)
    assert thr == jpx.pexit_threshold(JAX_P41, (6,), **kw)
    assert abs(thr - 0.9461) < 2e-3


@pytest.mark.parametrize("sigma,kw,want", [
    (0.80, dict(max_iters=150), True),   # plain MS below its ~0.825
    (0.86, dict(max_iters=150), False),  # ...and fails above it
    (0.86, dict(alpha=0.8, max_iters=200), True),  # normalization
])
def test_minsum_de_known_thresholds(sigma, kw, want):
    got = px.minsum_de_run(PROTO36, sigma, n_samples=4000, seed=1, **kw)
    assert got == jpx.minsum_de_run(PROTO36, sigma, n_samples=4000, seed=1,
                                    **kw)
    assert got[0] is want


@pytest.mark.parametrize("sigma,want", [(0.87, True), (0.90, False)])
def test_minsum_de_sum_product_mode_matches_ga(sigma, want):
    kw = dict(alg="sum-product", n_samples=4000, max_iters=250, seed=1)
    got = px.minsum_de_run(PROTO36, sigma, **kw)
    assert got == jpx.minsum_de_run(PROTO36, sigma, **kw)
    assert got[0] is want


def test_minsum_de_per_degree_alpha_and_puncture():
    kw = dict(alpha=((3, 1.0), (6, 0.9), (0, 0.875)), n_samples=4000,
              max_iters=150, seed=1)
    got = px.minsum_de_run(P41_BASE, 0.85, (6,), **kw)
    assert got == jpx.minsum_de_run(JAX_P41, 0.85, (6,), **kw)
    assert got[0]


def test_minsum_de_threshold_matches_jax():
    kw = dict(tol=0.02, n_samples=2000, max_iters=100, seed=2)
    thr = px.minsum_de_threshold(PROTO36, **kw)
    assert thr == jpx.minsum_de_threshold(PROTO36, **kw)
    assert 0.75 < thr < 0.85
