"""The port's regular QC passes against the JAX package's Pallas passes.

The JAX passes (``ops/qc_pallas.py``) run as the JAX package's own tests
run them on the CPU (Pallas interpret mode); the port's passes take their
plain PyTorch versions on CPU tensors. Both get the same state, made from a
seed with numpy and carried across by ``ldpc_decoder_tpu_torch.convert``,
on the all-ones (3,6) base at Z = 64 (the JAX tables' pair mode). Messages
are compared in float32 within PHI_RTOL (the XLA-vs-torch φ difference,
tests/test_torch_phi_channels.py: both sides sum in the same left-to-right
order, so φ is the only difference); sign bits, hard bits and parity flags
must be exact. The regular and grouped plain passes compute one function
on a regular base and must agree bit for bit.

The CUDA kernels are held to these plain versions on the card by
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from ldpc_decoder_tpu.channels import BIAWGNChannel as JaxBIAWGN  # noqa: E402
from ldpc_decoder_tpu.codes.qc import make_qc_code as jax_make_qc  # noqa: E402
from ldpc_decoder_tpu.ops import qc_pallas as jp  # noqa: E402
from ldpc_decoder_tpu.ops.qc_decode import (  # noqa: E402
    QCDecodeTables as JaxQCDecodeTables,
)
from ldpc_decoder_tpu.runtime.datagen import create_data  # noqa: E402

from ldpc_decoder_tpu_torch.codes.protographs import p41_code  # noqa: E402
from ldpc_decoder_tpu_torch.convert import (  # noqa: E402
    regular_state_from_jax,
    regular_state_to_jax,
    structure_from_numpy,
)
from ldpc_decoder_tpu_torch.ops import qc_grouped as qg  # noqa: E402
from ldpc_decoder_tpu_torch.ops import qc_regular as qr  # noqa: E402
from ldpc_decoder_tpu_torch.ops.qc_decode import QCDecodeTables  # noqa: E402

PHI_RTOL = 5e-5
BASE_36 = np.ones((3, 6), dtype=np.int8)
B = 8


def _port_qct(js):
    s = structure_from_numpy(js.Z, js.n_base_rows, js.n_base_cols,
                             js.edge_row, js.edge_col, js.edge_shift)
    return QCDecodeTables.from_structure(s, 0, "cpu")


@pytest.fixture(scope="module")
def small():
    jcode, js = jax_make_qc(BASE_36, Z=64, seed=2)
    jt = jp.QCPallasTables.from_qc_tables(JaxQCDecodeTables.from_structure(js))
    qct = _port_qct(js)
    t = qr.QCRegularTables.from_qc_tables(qct)
    ch = JaxBIAWGN(0.8)
    batch = create_data(jcode, ch, 0, B)
    llr2d = ch.llr_np(batch.values)[np.asarray(jt.vn_order)]
    syn2d = batch.syndromes[np.asarray(jt.cn_order)]
    return dict(jt=jt, t=t, qct=qct, llr2d=llr2d, syn2d=syn2d)


def _random_state(t, seed):
    rng = np.random.default_rng(seed)
    Z = t.Z
    return dict(
        msgs_v=(rng.standard_normal((t.C, t.d_v, Z, B)) * 4).astype(
            np.float32),
        r_c=(rng.standard_normal((t.R, t.d_c, Z, B)) * 4).astype(np.float32),
        llr=(rng.standard_normal((t.C, Z, B)) * 3).astype(np.float32),
        syn=(rng.random((t.R, Z, B)) < 0.5).astype(np.int8),
        fresh=rng.random(B) < 0.5,
    )


def _assert_msgs_close(port, ref):
    port = np.asarray(port, np.float32)
    ref = np.asarray(ref, np.float32)
    np.testing.assert_array_equal(np.signbit(port), np.signbit(ref))
    np.testing.assert_allclose(port, ref, rtol=PHI_RTOL, atol=0)


@pytest.mark.parametrize("Z,kw,mode", [
    (64, {}, "pair"),
    (1024, dict(coarse=256, fine_mod=4), "seam"),
])
def test_tables_match_jax(Z, kw, mode):
    """Source nodes, slots and absolute shifts equal the JAX read tables'
    (shifts rebuilt with qc_pallas._shift_of); parity reads the column of
    each check block (QCDecodeTables.cn_col_of_block)."""
    _, js = jax_make_qc(BASE_36, Z=Z, seed=6, **kw)
    jt = jp.QCPallasTables.from_qc_tables(JaxQCDecodeTables.from_structure(js))
    assert (jt.seam > 0) == (mode == "seam")
    qct = _port_qct(js)
    t = qr.QCRegularTables.from_qc_tables(qct)
    assert (t.C, t.R, t.d_v, t.d_c, t.Z) == (jt.C, jt.R, jt.d_v, jt.d_c, Z)
    for port, jax_read in ((t.cn_read, jt.cn_read), (t.vn_read, jt.vn_read)):
        jr = np.asarray(jax_read)
        np.testing.assert_array_equal(port.numpy()[..., :2], jr[..., :2])
        np.testing.assert_array_equal(port.numpy()[..., 2],
                                      np.asarray(jp._shift_of(jr, jt)))
    np.testing.assert_array_equal(t.cn_read.numpy()[..., 0].reshape(-1),
                                  qct.cn_col_of_block.numpy())
    for f in ("vn_pos", "vn_order", "cn_order", "erased_mask_sorted"):
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(jt, f)))


def test_tables_reject_irregular_base():
    _, s = p41_code(Z=128, m=4, coarse=64, fine_mod=16)
    with pytest.raises(ValueError, match="regular base"):
        qr.QCRegularTables.from_qc_tables(QCDecodeTables.from_structure(
            s, 0, "cpu"))


def test_state_conversion_round_trip(small):
    t = small["t"]
    st = _random_state(t, 1)
    mv2d, rc2d = regular_state_to_jax(st["msgs_v"], st["r_c"])
    assert mv2d.shape == rc2d.shape == (t.n_edges, B)
    mv, rc = regular_state_from_jax(mv2d, rc2d, t)
    np.testing.assert_array_equal(mv, st["msgs_v"])
    np.testing.assert_array_equal(rc, st["r_c"])


def test_init_messages_matches_jax(small):
    jt, t = small["jt"], small["t"]
    llr = small["llr2d"]
    jm = jp.init_messages_qc_pallas(jnp.asarray(llr), jt)
    ref, _ = regular_state_from_jax(np.asarray(jm), np.asarray(jm), t)
    mv, rc = qr.init_messages_qc_regular(
        torch.from_numpy(llr).view(t.C, t.Z, B), t)
    assert rc.shape == (t.R, t.d_c, t.Z, B)
    _assert_msgs_close(mv.numpy(), ref)


def test_cn_pass_matches_jax(small):
    jt, t = small["jt"], small["t"]
    st = _random_state(t, 2)
    ref = np.asarray(jp.cn_pass(jnp.asarray(st["msgs_v"]),
                                jnp.asarray(st["syn"]), jt))
    r_c = torch.from_numpy(st["r_c"].copy())
    out = qr.cn_pass_regular(torch.from_numpy(st["msgs_v"]),
                             torch.from_numpy(st["syn"]), r_c, t)
    assert out is r_c  # written in place
    _assert_msgs_close(out.numpy(), ref)


@pytest.mark.parametrize("emit,fresh", [
    (False, False),  # plain iteration
    (True, False),   # emit iteration
    (True, True),    # emit with refilled lanes (k = 1)
    (False, True),   # first iteration after a refill
])
def test_vn_pass_matches_jax(small, emit, fresh):
    jt, t = small["jt"], small["t"]
    st = _random_state(t, 3)
    fresh8 = None
    if fresh:
        fresh8 = jnp.broadcast_to(
            jnp.asarray(st["fresh"], jnp.float32)[None, :], (8, B))
    ref, bits_j = jp.vn_pass(jnp.asarray(st["r_c"]), jnp.asarray(st["llr"]),
                             jt, emit_bits=emit, fresh8=fresh8)
    msgs_v = torch.from_numpy(st["msgs_v"].copy())
    bits = torch.full((t.C, t.Z, B), -1, dtype=torch.int8) if emit else None
    out = qr.vn_pass_regular(
        torch.from_numpy(st["r_c"]), torch.from_numpy(st["llr"]), msgs_v, t,
        bits=bits, fresh=torch.from_numpy(st["fresh"]) if fresh else None)
    assert out is msgs_v
    _assert_msgs_close(out.numpy(), np.asarray(ref))
    if emit:
        np.testing.assert_array_equal(bits.numpy(), np.asarray(bits_j))


def test_parity_pass_matches_jax(small):
    jt, t = small["jt"], small["t"]
    rng = np.random.default_rng(4)
    bits = (rng.random((t.C, t.Z, B)) < 0.5).astype(np.int8)
    syn = np.asarray(jp.syndrome_from_bits_qc_pallas(
        jnp.asarray(bits.reshape(-1, B)), jt)).reshape(t.R, t.Z, B).copy()
    bad = [1, 5]
    syn[2, 17, bad] ^= 1
    ref = np.asarray(jp.parity_pass(jnp.asarray(bits), jnp.asarray(syn), jt))
    out = qr.parity_pass_regular(torch.from_numpy(bits),
                                 torch.from_numpy(syn), t).numpy()
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(np.nonzero(out)[0], bad)


@pytest.mark.parametrize("k", [1, 4])
def test_run_iterations_matches_jax(small, k):
    """A whole superstep on real frames with refilled lanes: hard bits and
    flags exact."""
    jt, t = small["jt"], small["t"]
    llr2d, syn2d = small["llr2d"], small["syn2d"]
    fresh = np.array([1, 0, 0, 1, 1, 0, 1, 0], bool)
    stale = -2.0 * llr2d + 1.0  # a retired frame's state for fresh lanes
    jm = jp.init_messages_qc_pallas(jnp.asarray(stale), jt)
    _, bits_j, viol_j = jp.run_iterations_qc_pallas(
        jm, jnp.asarray(llr2d), jnp.asarray(syn2d), jt, k,
        fresh=jnp.asarray(fresh.astype(np.int8)))

    def t3(x, rows):
        return torch.from_numpy(np.ascontiguousarray(x)).view(rows, t.Z, B)

    msgs = qr.init_messages_qc_regular(t3(stale, t.C), t)
    _, bits, viol = qr.run_iterations_qc_regular(
        msgs, t3(llr2d, t.C), t3(syn2d, t.R), t, k,
        fresh=torch.from_numpy(fresh))
    np.testing.assert_array_equal(bits.numpy().reshape(-1, B),
                                  np.asarray(bits_j))
    np.testing.assert_array_equal(viol.numpy(), np.asarray(viol_j))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_burst_prefix_identity(small, dtype):
    """burst(b) then run(k) equals run(b + k) bit for bit."""
    t = small["t"]
    llr = torch.from_numpy(small["llr2d"]).view(t.C, t.Z, B).to(dtype)
    syn = torch.from_numpy(small["syn2d"]).view(t.R, t.Z, B)
    m0 = qr.init_messages_qc_regular(llr, t, dtype)
    m1 = tuple(x.clone() for x in m0)
    qr.burst_iterations_qc_regular(m1, llr, syn, t, 3)
    m1, bits1, viol1 = qr.run_iterations_qc_regular(m1, llr, syn, t, 2)
    m2 = tuple(x.clone() for x in m0)
    m2, bits2, viol2 = qr.run_iterations_qc_regular(m2, llr, syn, t, 5)
    as_int = torch.int16 if dtype == torch.bfloat16 else torch.int32
    for a, b in zip(m1, m2):
        assert torch.equal(a.view(as_int), b.view(as_int))
    assert torch.equal(bits1, bits2)
    assert torch.equal(viol1, viol2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_regular_equals_grouped_bitwise(small, dtype):
    """On a regular base the grouped layout is the regular one flattened,
    and both families' plain passes compute the same bits."""
    t, qct = small["t"], small["qct"]
    tg = qg.GroupedQCTables.from_qc_tables(qct)
    assert len(tg.row_groups) == len(tg.col_groups) == 1
    st = _random_state(t, 5)
    mv = torch.from_numpy(st["msgs_v"]).to(dtype)
    rc = torch.from_numpy(st["r_c"]).to(dtype)
    llr = torch.from_numpy(st["llr"]).to(dtype)
    syn = torch.from_numpy(st["syn"])
    fresh = torch.from_numpy(st["fresh"])
    as_int = torch.int16 if dtype == torch.bfloat16 else torch.int32

    r_reg = qr.cn_pass_plain(mv, syn, torch.empty_like(rc), t)
    r_grp = qg.cn_pass_plain(mv.view(tg.nb, t.Z, B), syn,
                             torch.empty((tg.nb, t.Z, B), dtype=dtype), tg)
    assert torch.equal(r_reg.view(as_int).flatten(),
                       r_grp.view(as_int).flatten())
    for emit, fr in [(False, None), (True, fresh), (False, fresh)]:
        b_reg = torch.full((t.C, t.Z, B), -1, dtype=torch.int8)
        b_grp = b_reg.clone()
        m_reg = qr.vn_pass_plain(rc, llr, torch.empty_like(mv), t,
                                 bits=b_reg if emit else None, fresh=fr)
        m_grp = qg.vn_pass_plain(rc.view(tg.nb, t.Z, B), llr,
                                 torch.empty((tg.nb, t.Z, B), dtype=dtype),
                                 tg, bits=b_grp if emit else None, fresh=fr)
        assert torch.equal(m_reg.view(as_int).flatten(),
                           m_grp.view(as_int).flatten())
        assert torch.equal(b_reg, b_grp)
    bits = torch.from_numpy((np.random.default_rng(6).random(
        (t.C, t.Z, B)) < 0.5).astype(np.int8))
    assert torch.equal(qr.parity_pass_plain(bits, syn, t),
                       qg.parity_pass_plain(bits, syn, tg))


def test_passes_reject_other_devices(small):
    """Only CPU (plain) and CUDA (kernels) tensors are taken."""
    t = small["t"]
    m = torch.empty((t.C, t.d_v, t.Z, B), device="meta")
    r = torch.empty((t.R, t.d_c, t.Z, B), device="meta")
    syn = torch.empty((t.R, t.Z, B), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="device"):
        qr.cn_pass_regular(m, syn, r, t)
    with pytest.raises(ValueError, match="shape"):
        qr.cn_pass_regular(torch.zeros((t.C, t.d_v, t.Z, B)),
                           torch.zeros((t.R, t.Z, B + 1), dtype=torch.int8),
                           torch.zeros((t.R, t.d_c, t.Z, B)), t)
