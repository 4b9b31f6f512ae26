"""The port's grouped QC passes against the JAX package's Pallas passes.

The JAX passes run as the JAX package's own tests run them on the CPU
(Pallas interpret mode); the port's passes take their plain PyTorch
versions on CPU tensors. Both get the same state, made from a seed with
numpy and carried across by ``ldpc_decoder_tpu_torch.convert``, on the
small p41-shaped code. Messages are compared in float32 within PHI_RTOL
(the XLA-vs-torch φ difference, tests/test_torch_phi_channels.py: both
sides sum in the same left-to-right order, so φ is the only difference);
sign bits, hard bits and parity flags must be exact.

The CUDA kernels are held to these plain versions on the card by
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from ldpc_decoder_tpu.channels import BIAWGNChannel as JaxBIAWGN  # noqa: E402
from ldpc_decoder_tpu.codes.protographs import p41_code as jax_p41  # noqa: E402
from ldpc_decoder_tpu.ops import qc_pallas_grouped as jg  # noqa: E402
from ldpc_decoder_tpu.ops.qc_decode import (  # noqa: E402
    QCDecodeTables as JaxQCDecodeTables,
)
from ldpc_decoder_tpu.runtime.datagen import create_data  # noqa: E402

from ldpc_decoder_tpu_torch.convert import (  # noqa: E402
    grouped_state_from_jax,
    grouped_state_to_jax,
    structure_from_numpy,
)
from ldpc_decoder_tpu_torch.ops import qc_grouped as qg  # noqa: E402
from ldpc_decoder_tpu_torch.ops.qc_decode import QCDecodeTables  # noqa: E402

PHI_RTOL = 5e-5
SMALL = dict(Z=128, m=4, coarse=64, fine_mod=16)
B = 8


def _port_tables(js, n_erased, device="cpu"):
    s = structure_from_numpy(js.Z, js.n_base_rows, js.n_base_cols,
                             js.edge_row, js.edge_col, js.edge_shift)
    return qg.GroupedQCTables.from_qc_tables(
        QCDecodeTables.from_structure(s, n_erased, device))


@pytest.fixture(scope="module")
def small():
    jcode, js = jax_p41(**SMALL)
    jt = jg.GroupedQCPallasTables.from_qc_tables(
        JaxQCDecodeTables.from_structure(js, jcode.n_erased_vars), 4)
    t = _port_tables(js, jcode.n_erased_vars)
    ch = JaxBIAWGN(0.8)
    batch = create_data(jcode, ch, 0, B)
    llr2d = ch.llr_np(batch.values)[np.asarray(jt.vn_order)]
    syn2d = batch.syndromes[np.asarray(jt.cn_order)]
    return dict(jcode=jcode, js=js, jt=jt, t=t, llr2d=llr2d, syn2d=syn2d)


def _random_state(t, seed):
    rng = np.random.default_rng(seed)
    Z = t.Z
    return dict(
        msgs_v=(rng.standard_normal((t.nb, Z, B)) * 4).astype(np.float32),
        r_c=(rng.standard_normal((t.nb, Z, B)) * 4).astype(np.float32),
        llr=(rng.standard_normal((t.C, Z, B)) * 3).astype(np.float32),
        syn=(rng.random((t.R, Z, B)) < 0.5).astype(np.int8),
        fresh=rng.random(B) < 0.5,
    )


def _assert_msgs_close(port, ref):
    port = np.asarray(port, np.float32)
    ref = np.asarray(ref, np.float32)
    np.testing.assert_array_equal(np.signbit(port), np.signbit(ref))
    np.testing.assert_allclose(port, ref, rtol=PHI_RTOL, atol=0)


def _jax_shift(read, jt):
    toff, fine = read[:, 2].astype(np.int64), read[:, 3].astype(np.int64)
    return (toff * jt.tile + fine - jt.seam) % jt.Z


def test_group_tables_match_jax(small):
    jt, t = small["jt"], small["t"]
    for jgs, pgs in ((jt.row_groups, t.row_groups),
                     (jt.col_groups, t.col_groups)):
        assert [(g.node_start, g.count, g.degree) for g in jgs] == [
            (g.node_start, g.count, g.degree) for g in pgs]
    from ldpc_decoder_tpu_torch.convert import block_map

    pv = block_map(jt.col_groups, t.col_groups)
    pc = block_map(jt.row_groups, t.row_groups)
    cn_read = np.asarray(jt.cn_read)[pc]
    vn_read = np.asarray(jt.vn_read)[pv]
    col_read = np.asarray(jt.cn_col_read)[pc]
    np.testing.assert_array_equal(cn_read[:, 0], pv[t.cn_src.numpy()])
    np.testing.assert_array_equal(_jax_shift(cn_read, jt), t.cn_shift.numpy())
    np.testing.assert_array_equal(vn_read[:, 0], pc[t.vn_src.numpy()])
    np.testing.assert_array_equal(_jax_shift(vn_read, jt), t.vn_shift.numpy())
    np.testing.assert_array_equal(col_read[:, 0], t.par_src.numpy())
    np.testing.assert_array_equal(_jax_shift(col_read, jt),
                                  t.par_shift.numpy())
    for f in ("vn_pos", "vn_order", "cn_order", "erased_mask_sorted"):
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(jt, f)))


def test_state_conversion_round_trip(small):
    jt, t = small["jt"], small["t"]
    st = _random_state(t, 1)
    mv, rc = grouped_state_to_jax(st["msgs_v"], st["r_c"], jt, t)
    assert mv.shape == (jt.nbv_pad, t.Z, B) and rc.shape == (jt.nbc_pad,
                                                             t.Z, B)
    mv2, rc2 = grouped_state_from_jax(mv, rc, jt, t)
    np.testing.assert_array_equal(mv2, st["msgs_v"])
    np.testing.assert_array_equal(rc2, st["r_c"])


def test_init_messages_matches_jax(small):
    jt, t = small["jt"], small["t"]
    llr = small["llr2d"]
    jm, jr = jg.init_messages_qc_grouped(jnp.asarray(llr), jt)
    ref, _ = grouped_state_from_jax(np.asarray(jm), np.asarray(jr), jt, t)
    mv, rc = qg.init_messages_qc_grouped(
        torch.from_numpy(llr).view(t.C, t.Z, B), t)
    assert rc.shape == mv.shape
    _assert_msgs_close(mv.numpy(), ref)


def test_cn_pass_matches_jax(small):
    jt, t = small["jt"], small["t"]
    st = _random_state(t, 2)
    mv_j, rc_j = grouped_state_to_jax(st["msgs_v"], st["r_c"], jt, t)
    out_j = jg.cn_pass_grouped(jnp.asarray(mv_j), jnp.asarray(st["syn"]),
                               jnp.asarray(rc_j), jt)
    _, ref = grouped_state_from_jax(mv_j, np.asarray(out_j), jt, t)
    r_c = torch.from_numpy(st["r_c"].copy())
    out = qg.cn_pass_grouped(torch.from_numpy(st["msgs_v"]),
                             torch.from_numpy(st["syn"]), r_c, t)
    assert out is r_c  # written in place
    _assert_msgs_close(out.numpy(), ref)


@pytest.mark.parametrize("emit,fresh,include_d1", [
    (False, False, False),  # plain iteration: degree-1 groups skipped
    (True, False, False),   # emit iteration
    (True, True, False),    # emit with refilled lanes (k = 1)
    (False, True, True),    # first iteration after a refill
])
def test_vn_pass_matches_jax(small, emit, fresh, include_d1):
    jt, t = small["jt"], small["t"]
    st = _random_state(t, 3)
    mv_j, rc_j = grouped_state_to_jax(st["msgs_v"], st["r_c"], jt, t)
    fresh8 = None
    if fresh:
        fresh8 = jnp.broadcast_to(
            jnp.asarray(st["fresh"], jnp.float32)[None, :], (8, B))
    out_j, bits_j = jg.vn_pass_grouped(
        jnp.asarray(rc_j), jnp.asarray(st["llr"]), jnp.asarray(mv_j), jt,
        emit_bits=emit, fresh8=fresh8, include_d1=include_d1)
    ref, _ = grouped_state_from_jax(np.asarray(out_j), rc_j, jt, t)

    msgs_v = torch.from_numpy(st["msgs_v"].copy())
    bits = torch.full((t.C, t.Z, B), -1, dtype=torch.int8) if emit else None
    out = qg.vn_pass_grouped(
        torch.from_numpy(st["r_c"]), torch.from_numpy(st["llr"]), msgs_v, t,
        bits=bits, fresh=torch.from_numpy(st["fresh"]) if fresh else None,
        include_d1=include_d1)
    assert out is msgs_v
    _assert_msgs_close(out.numpy(), ref)
    if not (emit or include_d1):  # skipped degree-1 blocks are untouched
        d1 = t.col_groups[0]
        assert d1.degree == 1
        sl = slice(d1.block_start, d1.block_start + d1.count)
        np.testing.assert_array_equal(out.numpy()[sl], st["msgs_v"][sl])
    if emit:
        np.testing.assert_array_equal(bits.numpy(), np.asarray(bits_j))


def test_parity_pass_matches_jax(small):
    jt, t = small["jt"], small["t"]
    rng = np.random.default_rng(4)
    bits = (rng.random((t.C, t.Z, B)) < 0.5).astype(np.int8)
    syn = np.asarray(jg.syndrome_from_bits_qc_grouped(
        jnp.asarray(bits.reshape(-1, B)), jt)).reshape(t.R, t.Z, B).copy()
    bad = [1, 5]
    syn[3, 17, bad] ^= 1
    ref = np.asarray(jg.parity_pass_grouped(jnp.asarray(bits),
                                            jnp.asarray(syn), jt))
    out = qg.parity_pass_grouped(torch.from_numpy(bits),
                                 torch.from_numpy(syn), t).numpy()
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(np.nonzero(out)[0], bad)


@pytest.mark.parametrize("k,with_fresh", [(1, True), (4, True)])
def test_run_iterations_matches_jax(small, k, with_fresh):
    """A whole superstep on real frames: hard bits and flags exact."""
    jt, t = small["jt"], small["t"]
    llr2d, syn2d = small["llr2d"], small["syn2d"]
    fresh = np.array([1, 0, 0, 1, 1, 0, 1, 0], bool) if with_fresh else None
    stale = -2.0 * llr2d + 1.0  # a retired frame's state for fresh lanes
    jm = jg.init_messages_qc_grouped(jnp.asarray(stale), jt)
    _, bits_j, viol_j = jg.run_iterations_qc_grouped(
        jm, jnp.asarray(llr2d), jnp.asarray(syn2d), jt, k,
        fresh=None if fresh is None else jnp.asarray(fresh.astype(np.int8)))

    def t3(x, rows):
        return torch.from_numpy(np.ascontiguousarray(x)).view(rows, t.Z, B)

    msgs = qg.init_messages_qc_grouped(t3(stale, t.C), t)
    _, bits, viol = qg.run_iterations_qc_grouped(
        msgs, t3(llr2d, t.C), t3(syn2d, t.R), t, k,
        fresh=None if fresh is None else torch.from_numpy(fresh))
    np.testing.assert_array_equal(bits.numpy().reshape(-1, B),
                                  np.asarray(bits_j))
    np.testing.assert_array_equal(viol.numpy(), np.asarray(viol_j))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_burst_prefix_identity(small, dtype):
    """burst(b) then run(k) equals run(b + k) bit for bit."""
    t = small["t"]
    llr = torch.from_numpy(small["llr2d"]).view(t.C, t.Z, B).to(dtype)
    syn = torch.from_numpy(small["syn2d"]).view(t.R, t.Z, B)
    m0 = qg.init_messages_qc_grouped(llr, t, dtype)
    m1 = tuple(x.clone() for x in m0)
    qg.burst_iterations_qc_grouped(m1, llr, syn, t, 3)
    m1, bits1, viol1 = qg.run_iterations_qc_grouped(m1, llr, syn, t, 2)
    m2 = tuple(x.clone() for x in m0)
    m2, bits2, viol2 = qg.run_iterations_qc_grouped(m2, llr, syn, t, 5)
    for a, b in zip(m1, m2):
        assert torch.equal(a.view(torch.int16 if dtype == torch.bfloat16
                                  else torch.int32),
                           b.view(torch.int16 if dtype == torch.bfloat16
                                  else torch.int32))
    assert torch.equal(bits1, bits2)
    assert torch.equal(viol1, viol2)


def test_fresh_lane_reset_equals_true_init(small):
    """A fully fresh lane after k iterations equals a true-init lane after
    k - 1 iterations (the reset lane's first iteration is the reset)."""
    t = small["t"]
    llr = torch.from_numpy(small["llr2d"]).view(t.C, t.Z, B)
    syn = torch.from_numpy(small["syn2d"]).view(t.R, t.Z, B)
    stale = qg.init_messages_qc_grouped(-2.0 * llr + 1.0, t)
    _, bits_a, viol_a = qg.run_iterations_qc_grouped(
        stale, llr, syn, t, 3, fresh=torch.ones(B, dtype=torch.bool))
    true = qg.init_messages_qc_grouped(llr, t)
    _, bits_b, viol_b = qg.run_iterations_qc_grouped(true, llr, syn, t, 2)
    assert torch.equal(bits_a, bits_b)
    assert torch.equal(viol_a, viol_b)


def test_passes_reject_other_devices(small):
    """Only CPU (plain) and CUDA (kernels) tensors are taken."""
    t = small["t"]
    m = torch.empty((t.nb, t.Z, B), device="meta")
    syn = torch.empty((t.R, t.Z, B), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="device"):
        qg.cn_pass_grouped(m, syn, torch.empty_like(m), t)
    with pytest.raises(ValueError, match="shape"):
        qg.cn_pass_grouped(torch.zeros((t.nb, t.Z, B)),
                           torch.zeros((t.R, t.Z, B + 1), dtype=torch.int8),
                           torch.zeros((t.nb, t.Z, B)), t)
