"""On-device numerics smoke checks: the CUDA twin of
``ldpc_decoder_tpu/runtime/smoke.py``.

The φ tail is load-bearing: for x > 5 the decoder must use 2e^{-x}, since a
saturating tanh (the v5e's hardware tanh, or a fast-math ``tanh.approx`` on
the GPU) turns -log(tanh(x/2)) into -0.0, the message loses its sign and
decoding collapses. A CPU test cannot see what the card's math library
does, so this module checks φ on the card, through the kernels themselves:
a degree-2 check whose slot 0 carries +0 and slot 1 carries x makes the
check kernel write φ(x + 0 − 0) = φ(x) exactly at slot 0, with the sign of
x (the sign-bit algebra of a degree-2 check with syndrome 0).
"""

from __future__ import annotations

import numpy as np
import torch

# φ on the card vs float64: rel + abs bound (measured on an H100: max rel
# 2.43e-6 near x = 5, so 1e-5 keeps a 4x margin)
PHI_RTOL, PHI_ATOL = 1e-5, 1e-7


def _check_phi(x: np.ndarray, dtype: torch.dtype, family: str,
               device: torch.device, phi: str = "fast") -> torch.Tensor:
    """φ of every x (float32, signed) through one check-kernel launch of
    ``family`` with ``dtype`` messages and its ``phi`` policy; returns slot
    0 of the check pass, [Z] on the card."""
    from ldpc_decoder_tpu_torch.codes.qc import QCStructure
    from ldpc_decoder_tpu_torch.ops import qc_grouped as qg
    from ldpc_decoder_tpu_torch.ops import qc_regular as qr
    from ldpc_decoder_tpu_torch.ops.qc_decode import QCDecodeTables

    Z = x.size
    s = QCStructure(Z=Z, n_base_rows=1, n_base_cols=2,
                    edge_row=np.array([0, 0], np.int32),
                    edge_col=np.array([0, 1], np.int32),
                    edge_shift=np.array([0, 0], np.int32))
    qct = QCDecodeTables.from_structure(s, 0, device)
    msgs = torch.zeros((2, Z, 1), dtype=torch.float32, device=device)
    msgs[1, :, 0] = torch.from_numpy(x).to(device)
    msgs = msgs.to(dtype)
    syn = torch.zeros((1, Z, 1), dtype=torch.int8, device=device)
    if family == "grouped":
        t = qg.GroupedQCTables.from_qc_tables(qct)
        r_c = qg.cn_pass_grouped(msgs, syn, torch.empty_like(msgs), t,
                                 _phi=phi)
        return r_c[0, :, 0]
    t = qr.QCRegularTables.from_qc_tables(qct)
    r_c = torch.empty((1, 2, Z, 1), dtype=dtype, device=device)
    return qr.cn_pass_regular(msgs.view(2, 1, Z, 1), syn, r_c, t,
                              _phi=phi)[0, 0, :, 0]


def _phi_sweep(x: np.ndarray, phi: str, device: torch.device, name: str,
               family: str = "grouped") -> tuple[np.ndarray, np.ndarray]:
    """φ of the sweep through ``family``'s float32 check kernel with
    ``phi``, in float64, and its relative error against float64; asserts
    positivity and the rel + abs bound."""
    from ldpc_decoder_tpu_torch.ops.phi import phi_abs_np

    got = _check_phi(x, torch.float32, family, device, phi).double()
    got = got.cpu().numpy()
    ref = phi_abs_np(x)
    assert (got > 0).all(), (
        f"{family} {phi} phi <= 0 on {name} at x = {x[got <= 0][:5]}: the "
        f"x > 5 tail (ops/phi.py, csrc/common.cuh, csrc/sum_product.cuh) "
        f"has regressed")
    ok = np.abs(got - ref) <= PHI_RTOL * ref + PHI_ATOL
    assert ok.all(), (f"{family} {phi} phi on {name} out of bound (rel "
                      f"{PHI_RTOL} + abs {PHI_ATOL}) at x = {x[~ok][:5]}")
    return got, np.abs(got - ref) / ref


def cuda_numerics_smoke(device: torch.device | str = "cuda",
                        verbose=print) -> dict[str, float]:
    """Assert the φ invariants hold on the card, through kernel launches.

    Raises RuntimeError without a CUDA device, AssertionError on a
    regression. Checks, for the grouped kernels' fast φ (the decoder's)
    and their accurate one: φ > 0 up to the clamp at 80 (the Taylor tail),
    φ against float64 over [1e-5, 80] and finely around the switch at 5;
    the fast φ within PHI_FAST_MAX_REL_ERR of float64 there, through the
    regular kernel too (the same bits as the grouped one); the
    self-inverse round trip φ(φ(x)) ≈ x through the fast φ; and, under
    both policies, that the regular family's float8_e5m2 clamp keeps
    φ(±10) a normal e5m2 with its sign and gives every input above 10
    φ(10). Returns the measured figures (``phi_*``: the grouped fast φ,
    ``phi_accurate_*``: the accurate one, ``phi_regular_*``: the regular
    fast one)."""
    from ldpc_decoder_tpu_torch.ops.phi import (
        HIGH_THRESHOLD,
        PHI_FAST_MAX_REL_ERR,
    )

    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"cuda_numerics_smoke needs a CUDA device, got "
                           f"{device} (available: "
                           f"{torch.cuda.is_available()})")
    name = torch.cuda.get_device_name(device)

    # 1. φ stays strictly positive up to the high clamp, and matches the
    #    float64 reference across the operating range
    x = np.concatenate([
        np.logspace(-5, np.log10(HIGH_THRESHOLD), 60000),
        np.linspace(4.99, 5.01, 4001),
        [5.0, np.nextafter(np.float32(5), np.float32(0)),
         np.nextafter(np.float32(5), np.float32(9)), 6.0, 12.0, 25.0, 50.0,
         HIGH_THRESHOLD],
    ]).astype(np.float32)
    acc, rel_acc = _phi_sweep(x, "accurate", device, name)
    got, rel = _phi_sweep(x, "fast", device, name)
    reg, rel_reg = _phi_sweep(x, "fast", device, name, "regular")
    for label, r in (("grouped", rel), ("regular", rel_reg)):
        assert r.max() <= PHI_FAST_MAX_REL_ERR, (
            f"{label} fast phi on {name}: max rel err {r.max():.3e} at x = "
            f"{x[r.argmax()]} > {PHI_FAST_MAX_REL_ERR}")
    assert np.array_equal(reg, got), "regular and grouped fast phi differ"

    # 2. the self-inverse round trip keeps the operating range stable
    mid = np.geomspace(1e-4, 11.0, 32).astype(np.float32)
    once = _check_phi(mid, torch.float32, "grouped", device).cpu().numpy()
    twice = _check_phi(once, torch.float32, "grouped", device).cpu().numpy()
    rt = float((np.abs(twice - mid) / mid).max())
    assert rt < 2e-2, f"phi round trip error {rt:.2e} on {name}"

    # 3. float8_e5m2 in the regular family, both policies: φ(±10) =
    #    ±9.08e-5, stored as a normal e5m2 (exponent field > 0) with its
    #    sign, and every input above 10 clamped to it
    above = np.array([10.0, -10.0, 12.0, -14.0, 448.0, 57344.0], np.float32)
    for phi in ("fast", "accurate"):
        bits = _check_phi(above, torch.float8_e5m2, "regular", device, phi)
        bits = bits.view(torch.uint8).cpu().numpy()
        assert ((bits & 0x7C) != 0).all(), (
            f"{phi} phi(10) subnormal in e5m2: {bits}")
        assert list(bits >> 7) == [0, 1, 0, 1, 0, 0], (
            f"{phi} phi(+-10) lost its sign: {bits}")
        assert ((bits & 0x7F) == bits[0]).all(), (
            f"{phi} phi's e5m2 clamp at 10 does not hold: {bits}")

    out = {"phi_max_rel_err": float(rel.max()),
           "phi_worst_x": float(x[rel.argmax()]),
           "phi_min": float(got.min()),
           "phi_accurate_max_rel_err": float(rel_acc.max()),
           "phi_accurate_worst_x": float(x[rel_acc.argmax()]),
           "phi_accurate_min": float(acc.min()),
           "phi_regular_max_rel_err": float(rel_reg.max()),
           "phi_regular_worst_x": float(x[rel_reg.argmax()]),
           "phi_round_trip_rel_err": rt,
           "phi10_e5m2": float(torch.tensor(bits[:1]).view(
               torch.float8_e5m2).float())}
    for label, key in (("fast", "phi"), ("accurate", "phi_accurate")):
        verbose(f"smoke[{name}]: {label} phi vs float64 over {x.size} "
                f"points in [1e-5, {HIGH_THRESHOLD:g}]: max rel err "
                f"{out[key + '_max_rel_err']:.3e} at x = "
                f"{out[key + '_worst_x']:.6g} (bound rel {PHI_RTOL} + abs "
                f"{PHI_ATOL}); min phi {out[key + '_min']:.3e}")
    verbose(f"smoke[{name}]: regular fast phi (float32 check kernel) max "
            f"rel err {out['phi_regular_max_rel_err']:.3e} at x = "
            f"{out['phi_regular_worst_x']:.6g}, the grouped kernel's bits")
    verbose(f"smoke[{name}]: fast phi within {PHI_FAST_MAX_REL_ERR} of "
            f"float64; round trip {rt:.1e}; phi(10) as e5m2 "
            f"{out['phi10_e5m2']:.4g} (normal, signed, the clamp at 10 "
            f"held), both policies")
    return out
