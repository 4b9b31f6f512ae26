"""Fit the coefficients of the QC kernels' fast φ (``phi_abs_fast``).

    python -m ldpc_decoder_tpu_torch.ops.phi_fit   # prints the constants

φ_abs(x) = -ln(tanh(x/2)) is evaluated in two pieces, each a polynomial
of degree 3 in a square, fitted here in float64 and rounded to float32:

- below ``SPLIT``: φ = -ln(x) + h(x²), h(u) ≈ ln(2) + ln((x/2)/tanh(x/2))
  (an even function, analytic for |x| < 2π, so a short series in x²);
  -ln(x) and h are both positive there, so the sum does not cancel;
- from ``SPLIT`` up: φ = 2·atanh(t) = t·P(t²) with t = e^{-x}, P(u) ≈
  2·atanh(t)/t, which has no cancellation near x = 5 (where -ln(tanh)
  takes the log of a number near 1); above 5 the reference's tail is
  2·e^{-x}, P = 2.

Each fit minimises φ's relative error over its interval (Lawson's
iteratively reweighted least squares on Chebyshev points, a fixed number
of iterations, so the result is deterministic). ``ops/phi.py`` and
``csrc/sum_product.cuh`` hold copies of the rounded constants; the tests
check that this script reproduces them.
"""

from __future__ import annotations

import numpy as np

SPLIT = 1.0      # where the two pieces meet
TAIL = 5.0       # the reference's branch to 2·e^{-x} (flood.cu:32)
DEGREE = 3       # of each polynomial, in its squared argument
N_POINTS = 4001  # Chebyshev points per interval
N_ITER = 60      # Lawson iterations


def _lawson(u: np.ndarray, target: np.ndarray, weight: np.ndarray,
            degree: int) -> np.ndarray:
    """Coefficients (lowest first) of the polynomial in ``u`` that
    minimises max |weight·(poly(u) − target)|."""
    V = np.vander(u, degree + 1, increasing=True)
    w = np.full(u.size, 1.0 / u.size)
    for _ in range(N_ITER):
        sw = np.sqrt(w) * weight
        c = np.linalg.lstsq(V * sw[:, None], target * sw, rcond=None)[0]
        err = np.abs(weight * (V @ c - target))
        w = w * err
        w /= w.sum()
    return c


def _cheb(a: float, b: float) -> np.ndarray:
    return a + (b - a) * (0.5 - 0.5 * np.cos(np.linspace(0.0, np.pi,
                                                          N_POINTS)))


def fit() -> tuple[tuple[float, ...], tuple[float, ...]]:
    """(small, mid): float32 coefficients of h(u) and P(u), lowest first,
    as Python floats."""
    x = _cheb(0.0, SPLIT)[1:]  # x = 0 is a pole of φ, not of h
    phi = -np.log(np.tanh(0.5 * x))
    small = _lawson(x * x, phi + np.log(x), 1.0 / phi, DEGREE)
    t = np.exp(-_cheb(SPLIT, TAIL))
    p = 2.0 * np.arctanh(t) / t
    mid = _lawson(t * t, p, 1.0 / p, DEGREE)
    as_f32 = lambda c: tuple(float(np.float32(v)) for v in c)  # noqa: E731
    return as_f32(small), as_f32(mid)


def main() -> None:
    small, mid = fit()
    for name, c in (("PHI_FAST_SMALL", small), ("PHI_FAST_MID", mid)):
        print(f"{name} = ({', '.join(v.hex() for v in c)})")
        print(f"  C: {{{', '.join(v.hex() + 'f' for v in c)}}}")


if __name__ == "__main__":
    main()
