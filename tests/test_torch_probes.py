"""The probes (``ldpc_decoder_tpu_torch.probes``) against the TPU scripts
they replace, on the CPU at a small size (Z <= 2048, B = 128).

The probe wrappers take their plain PyTorch versions on CPU tensors; the
CUDA kernels are held to those plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py's phase 30. Inputs are made
with numpy from a seed.

- ``scripts/proto_window.py``'s ``kern_a``, ``kern_b`` and ``kern_c`` run
  through ``pl.pallas_call(..., interpret=True)`` with the script's own
  ``make_specs`` (the interpret mode the JAX tests use; ``pltpu.roll`` has
  an interpret rule), against the staged, direct and aligned window sums:
  bit for bit (float32 sums in the same order, bfloat16 stores).
- ``micro2.py``'s and ``micro3.py``'s copy kernels are nested in their
  ``main()``; the row copy is held against numpy statements of their index
  maps (``micro2.py:117-125``, ``micro3.py:56-58``), bit for bit.
- φ^k against ``ldpc_decoder_tpu.ops.qc_pallas._phi_abs_f32`` (the φ the
  overlap scripts import) under ``jax.jit``: PERF.md's φ tolerance,
  1.74e-5 relative (XLA's tanh near x = 5), for every k; φ stubbed is
  exact.
- The leave-one-out sign algebra against a numpy statement of
  ``micro_overlap6.py:86-100``: signs exact, φ stubbed bit for bit.
- The gather against ``jnp.take``, bit for bit.
- The window kernels' launch plan and the staged blocks' bulk-copy runs
  (``probes.kernels.window_plan``, ``stage_runs``, the Python mirrors that
  the library is checked against when it loads): the runs cover exactly
  the rotated rows, a wrap included; a staged model built from them
  equals the plain window stream bit for bit; every instantiated shape
  fits the H100's 227 KB of shared memory and the grid's limits.
- Row 11's fresh-output iterations against the in-place ones (bit for
  bit) and against the JAX package's grouped passes in interpret mode, on
  the small p41-shaped code (it has a degree-1 group).
"""

import importlib.util
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from ldpc_decoder_tpu.channels import BIAWGNChannel as JaxBIAWGN  # noqa: E402
from ldpc_decoder_tpu.codes.protographs import p41_code as jax_p41  # noqa: E402
from ldpc_decoder_tpu.ops import qc_pallas_grouped as jg  # noqa: E402
from ldpc_decoder_tpu.ops.qc_decode import (  # noqa: E402
    QCDecodeTables as JaxQCDecodeTables,
)
from ldpc_decoder_tpu.ops.qc_pallas import _phi_abs_f32  # noqa: E402
from ldpc_decoder_tpu.runtime.datagen import create_data  # noqa: E402

from ldpc_decoder_tpu_torch import probes  # noqa: E402
from ldpc_decoder_tpu_torch.convert import (  # noqa: E402
    grouped_state_from_jax,
    structure_from_numpy,
)
from ldpc_decoder_tpu_torch.ops import _kernels  # noqa: E402
from ldpc_decoder_tpu_torch.ops import qc_grouped as qg  # noqa: E402
from ldpc_decoder_tpu_torch.ops.phi import phi_abs_np  # noqa: E402
from ldpc_decoder_tpu_torch.ops.qc_decode import QCDecodeTables  # noqa: E402
from ldpc_decoder_tpu_torch.probes import _common as C  # noqa: E402
from ldpc_decoder_tpu_torch.probes import noalias  # noqa: E402
from ldpc_decoder_tpu_torch.probes import phi_overlap  # noqa: E402
from ldpc_decoder_tpu_torch.probes.__main__ import main  # noqa: E402
from ldpc_decoder_tpu_torch.probes import kernels as K  # noqa: E402
from ldpc_decoder_tpu_torch.probes.kernels import (  # noqa: E402
    BYTES_PER_THREAD,
    row_copy,
    row_copy_plain,
    window_stream,
    window_stream_plain,
)
from ldpc_decoder_tpu_torch.runtime import perf  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHI_RTOL = 1.74e-5  # XLA's φ against torch's, per evaluation (PERF.md)
SMALL = dict(Z=128, m=4, coarse=64, fine_mod=16)


def _script(name):
    """A module of scripts/ (imported, not run: its main() is guarded)."""
    spec = importlib.util.spec_from_file_location(
        f"scripts_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _t(x):
    return torch.from_numpy(np.array(x))  # a writable copy


def _bf16(x):
    """float32 numpy -> (the same bfloat16 values as a jax array, as a
    torch tensor)."""
    j = jnp.asarray(x, jnp.bfloat16)
    return j, _t(np.asarray(j.astype(jnp.float32))).to(torch.bfloat16)


# ---- row 16: proto_window.py ------------------------------------------------

@pytest.fixture(scope="module")
def proto():
    pw = _script("proto_window")
    D, R, T, NT, B = 6, 3, 64, 8, 128
    rng = np.random.default_rng(16)
    msgs, src = _bf16(rng.standard_normal((D, D, T * NT, B)).astype(
        np.float32))
    tab = np.zeros((R, D, 4), np.int32)
    tab[..., 0] = rng.integers(0, D, (R, D))
    tab[..., 1] = rng.integers(0, D, (R, D))
    tab[..., 2] = rng.integers(0, NT, (R, D))
    tab[..., 3] = rng.integers(0, T, (R, D))
    return dict(pw=pw, D=D, R=R, T=T, NT=NT, B=B, msgs=msgs,
                src=src.view(D * D, T * NT, B), tab=tab)


@pytest.mark.parametrize("kern,mode", [("kern_a", "staged"),
                                       ("kern_b", "direct"),
                                       ("kern_c", "aligned")])
def test_window_sums_match_proto_window(proto, kern, mode):
    """A (staged), B (roll; direct) and C (aligned) of the script in
    interpret mode equal the window sums bit for bit."""
    from functools import partial

    pw, D, R, T, NT, B = (proto[k] for k in ("pw", "D", "R", "T", "NT", "B"))
    LB = pw.LB
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1, grid=(R, NT, B // LB),
        in_specs=pw.make_specs(D, T, NT, LB),
        out_specs=pl.BlockSpec((1, 1, T, LB), lambda i, j, l, *_: (i, 0, j, l),
                               memory_space=pltpu.VMEM),
        scratch_shapes=([pltpu.VMEM((2 * T, LB), jnp.float32)]
                        if kern == "kern_a" else []))
    out = pl.pallas_call(
        partial(getattr(pw, kern), d=D, tile=T), grid_spec=grid_spec,
        out_shape=jax.ShapeDtypeStruct((R, 1, T * NT, B), jnp.bfloat16),
        interpret=True)(jnp.asarray(proto["tab"]),
                        *([proto["msgs"]] * (2 * D)))
    ref = np.asarray(out.astype(jnp.float32))[:, 0]
    tab = proto["tab"]
    blocks = _t((tab[..., 0] * D + tab[..., 1]).reshape(-1))
    fine = tab[..., 3] if kern != "kern_c" else 0
    shifts = _t((tab[..., 2] * T + fine).reshape(-1).astype(np.int32))
    res = window_stream(proto["src"], blocks, shifts, D, 0, mode)
    assert res.dtype == torch.bfloat16 and res.shape == (R, T * NT, B)
    np.testing.assert_array_equal(res.float().numpy(), ref)


# ---- rows 12 and 13: micro2.py and micro3.py --------------------------------

def test_row_copy_matches_micro2_index_map():
    """micro2.py:117-125: out[i, k] tile j = msgs[tab0, tab1] tile (tab2 +
    j) mod NT, at the reg36 shape's counts (C = 32, d_v = 3, R = 16, d_c
    = 6)."""
    C, d_v, R, d_c, T, NT, B = 32, 3, 16, 6, 64, 4, 128
    Z = T * NT
    rng = np.random.default_rng(12)
    msgs = rng.standard_normal((C, d_v, Z, B)).astype(np.float32)
    tab = np.stack([rng.integers(0, C, (R, d_c)),
                    rng.integers(0, d_v, (R, d_c)),
                    rng.integers(0, NT, (R, d_c))], axis=-1)
    ref = np.empty((R, d_c, Z, B), np.float32)
    for i in range(R):
        for k in range(d_c):
            for j in range(NT):
                t0 = (tab[i, k, 2] + j) % NT
                ref[i, k, j * T:(j + 1) * T] = msgs[tab[i, k, 0], tab[i, k, 1],
                                                    t0 * T:(t0 + 1) * T]
    blocks = _t((tab[..., 0] * d_v + tab[..., 1]).reshape(-1).astype(np.int32))
    shifts = _t((tab[..., 2] * T).reshape(-1).astype(np.int32))
    out = row_copy(_t(msgs).view(C * d_v, Z, B), blocks, shifts)
    np.testing.assert_array_equal(out.view(R, d_c, Z, B).numpy(), ref)


@pytest.mark.parametrize("dtype", [np.float32, np.int8])
def test_row_copy_matches_micro3_index_map(dtype):
    """micro3.py:56-58: node i's block k, tile j = src[tab0] tile (tab2 +
    j) mod NT, every node into its own output blocks; also 1-byte rows."""
    N, R, d, T, NT, W = 96, 16, 6, 64, 8, 128
    Zq = T * NT
    rng = np.random.default_rng(13)
    src = (rng.standard_normal((N, Zq, W)) * 40).astype(dtype)
    tab = np.stack([rng.integers(0, N, (R, d)), rng.integers(0, NT, (R, d))],
                   axis=-1)
    ref = np.empty((R * d, Zq, W), dtype)
    for i in range(R):
        for k in range(d):
            for j in range(NT):
                t0 = (tab[i, k, 1] + j) % NT
                ref[i * d + k, j * T:(j + 1) * T] = src[tab[i, k, 0],
                                                        t0 * T:(t0 + 1) * T]
    out = row_copy(_t(src), _t(tab[..., 0].reshape(-1).astype(np.int32)),
                   _t((tab[..., 1] * T).reshape(-1).astype(np.int32)))
    np.testing.assert_array_equal(out.numpy(), ref)


# ---- row 14: φ and the leave-one-out of the overlap scripts ----------------

@pytest.mark.parametrize("k", [1, 2, 4])
def test_phi_steps_match_jax(k):
    """k chained φ_abs(|v| + 0.125) (micro_overlap2/3/4's φ^k) against
    _phi_abs_f32 under jit; the stub (v + 0.125) exactly."""
    rng = np.random.default_rng(14)
    x = np.concatenate([rng.standard_normal((2, 256, 128)) + 1.5,
                        rng.uniform(4.5, 5.5, (2, 256, 128)),
                        rng.uniform(0.0, 1e-4, (1, 256, 128))]).astype(
        np.float32)
    ident = torch.arange(5, dtype=torch.int32)
    zero = torch.zeros(5, dtype=torch.int32)

    @jax.jit
    def steps(v):
        for _ in range(k):
            v = _phi_abs_f32(jnp.abs(v) + 0.125)
        return v

    ref = np.asarray(steps(jnp.asarray(x)))
    res = window_stream_plain(_t(x), ident, zero, 1, k).numpy()
    np.testing.assert_allclose(res, ref, rtol=PHI_RTOL, atol=0)
    stub = window_stream_plain(_t(x), ident, zero, 1, k, phi_live=False)
    want = x.copy()
    for _ in range(k):
        want = want + np.float32(0.125)
    np.testing.assert_array_equal(stub.numpy(), want)


def _overlap6_numpy(ws, syn, live):
    """micro_overlap6.py:86-100 in numpy float32 (φ in float64)."""
    sbit = np.uint32(0x80000000)
    sb = [w.view(np.uint32) & sbit for w in ws]
    X = syn.astype(np.uint32) << np.uint32(31)
    for b in sb:
        X = X ^ b
    a = [np.abs(w) for w in ws]
    ext = a[0]
    for x in a[1:]:
        ext = ext + x
    out = []
    for s in range(len(ws)):
        v = ext - a[s]
        res = (phi_abs_np(v + np.float32(0.125)).astype(np.float32) if live
               else v + np.float32(0.125))
        out.append((res.view(np.uint32) | (sb[s] ^ X)).view(np.float32))
    return np.stack(out, axis=1)


@pytest.mark.parametrize("live", [False, True])
def test_leave_one_out_matches_overlap6(live):
    """The sign algebra and syndrome XOR: signs exact; φ stubbed bit for
    bit, φ live within PHI_RTOL of float64."""
    nodes, D, Z, B, NB = 2, 6, 256, 128, 16
    rng = np.random.default_rng(6)
    src = rng.standard_normal((NB, Z, B)).astype(np.float32)
    blocks = rng.permutation(NB)[:nodes * D].astype(np.int32)
    shifts = rng.integers(0, Z, nodes * D).astype(np.int32)
    syn = rng.integers(0, 2, (nodes, Z, B)).astype(np.int8)
    ws = [np.stack([np.roll(src[blocks[i * D + s]], -shifts[i * D + s], 0)
                    for i in range(nodes)]) for s in range(D)]
    ref = _overlap6_numpy(ws, syn, live).reshape(nodes * D, Z, B)
    res = window_stream(_t(src), _t(blocks), _t(shifts), D, 1, "direct",
                        "loo", phi_live=live, syn=_t(syn)).numpy()
    np.testing.assert_array_equal(np.signbit(res), np.signbit(ref))
    if live:
        np.testing.assert_allclose(res, ref, rtol=PHI_RTOL, atol=0)
    else:
        np.testing.assert_array_equal(res.view(np.uint32),
                                      ref.view(np.uint32))


# ---- row 15: micro_gather.py ------------------------------------------------

@pytest.mark.parametrize("dtype,index", [(np.float32, np.int32),
                                         (np.float32, np.int64),
                                         (np.int8, np.int32)])
def test_gather_matches_jnp_take(dtype, index):
    rng = np.random.default_rng(15)
    src = (rng.standard_normal((2048, 128)) * 40).astype(dtype)
    idx = rng.permutation(2048).astype(index)
    ref = np.asarray(jnp.take(jnp.asarray(src), jnp.asarray(idx), axis=0))
    np.testing.assert_array_equal(row_copy(_t(src), index=_t(idx)).numpy(),
                                  ref)


# ---- row 11: debug_grouped.py -----------------------------------------------

@pytest.fixture(scope="module")
def p41_small():
    jcode, js = jax_p41(**SMALL)
    s = structure_from_numpy(js.Z, js.n_base_rows, js.n_base_cols,
                             js.edge_row, js.edge_col, js.edge_shift)
    t = qg.GroupedQCTables.from_qc_tables(
        QCDecodeTables.from_structure(s, jcode.n_erased_vars, "cpu"))
    jt = jg.GroupedQCPallasTables.from_qc_tables(
        JaxQCDecodeTables.from_structure(js, jcode.n_erased_vars), 4)
    ch, B = JaxBIAWGN(0.8), 8
    batch = create_data(jcode, ch, 0, B)
    llr2d = ch.llr_np(batch.values)[np.asarray(jt.vn_order)]
    syn2d = batch.syndromes[np.asarray(jt.cn_order)]
    return dict(t=t, jt=jt, llr2d=llr2d, syn2d=syn2d, B=B)


def test_noalias_has_degree1_group(p41_small):
    assert p41_small["t"].col_groups[0].degree == 1


@pytest.mark.parametrize("assemble", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_noalias_equals_in_place(p41_small, assemble, dtype):
    """Fresh outputs (the degree-1 blocks carried over), with or without the
    concatenation, give the in-place run's messages, bits and flags."""
    t, B = p41_small["t"], p41_small["B"]
    llr = _t(p41_small["llr2d"]).view(t.C, t.Z, B).to(dtype)
    syn = _t(p41_small["syn2d"]).view(t.R, t.Z, B)
    msgs = qg.init_messages_qc_grouped(llr, t, dtype)
    before = tuple(x.clone() for x in msgs)
    (mv, rc), bits, flags = noalias.run_iterations_fresh(msgs, llr, syn, t,
                                                         6, assemble=assemble)
    as_int = torch.int16 if dtype == torch.bfloat16 else torch.int32
    for x, y in zip(msgs, before):  # the input state is left alone
        assert torch.equal(x.view(as_int), y.view(as_int))
    (mv_i, rc_i), bits_i, flags_i = qg.run_iterations_qc_grouped(
        msgs, llr, syn, t, 6)
    for a, b in ((mv, mv_i), (rc, rc_i)):
        assert torch.equal(a.view(as_int), b.view(as_int))
    assert torch.equal(bits, bits_i) and torch.equal(flags, flags_i)


@pytest.mark.parametrize("k", [1, 4])
def test_noalias_matches_jax(p41_small, k):
    """Fresh-output iterations against the JAX grouped passes (interpret
    mode), as tests/test_torch_qc_grouped.py holds the in-place ones: bits
    and flags exact; after one iteration the messages too, within 5e-5
    relative (φ's XLA-vs-torch difference through one check and one
    variable pass; over more iterations it compounds)."""
    t, jt, B = p41_small["t"], p41_small["jt"], p41_small["B"]
    llr2d, syn2d = p41_small["llr2d"], p41_small["syn2d"]
    jm = jg.init_messages_qc_grouped(jnp.asarray(llr2d), jt)
    (jmv, jrc), bits_j, viol_j = jg.run_iterations_qc_grouped(
        jm, jnp.asarray(llr2d), jnp.asarray(syn2d), jt, k)
    llr = _t(llr2d).view(t.C, t.Z, B)
    syn = _t(syn2d).view(t.R, t.Z, B)
    (mv, rc), bits, viol = noalias.run_iterations_fresh(
        qg.init_messages_qc_grouped(llr, t), llr, syn, t, k)
    np.testing.assert_array_equal(bits.numpy().reshape(-1, B),
                                  np.asarray(bits_j))
    np.testing.assert_array_equal(viol.numpy(), np.asarray(viol_j))
    if k == 1:
        ref_mv, ref_rc = grouped_state_from_jax(
            np.asarray(jmv), np.asarray(jrc), jt, t)
        for got, ref in ((mv.numpy(), ref_mv), (rc.numpy(), ref_rc)):
            np.testing.assert_array_equal(np.signbit(got), np.signbit(ref))
            np.testing.assert_allclose(got, ref, rtol=5e-5, atol=0)


# ---- the entry point and the wrappers ---------------------------------------

def test_entry_point_runs_every_probe_on_the_cpu(capsys):
    """``--device cpu``: one JSON record per measurement, every probe, no
    times (a CPU run measures no device), bounds from the bytes."""
    assert main(["--device", "cpu"]) == 0
    recs = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert {r["probe"] for r in recs} == set(probes.PROBES)
    for r in recs:
        assert r["ms"] is None and r["gbps"] is None
        if r["probe"] in ("overlap2", "overlap3", "overlap4", "overlap6",
                          "window_read"):
            assert r["queued_ms"] is None and "queued_library_ms" in r
        assert r["card"] == "cpu" and r["bound_ms"] > 0
        assert r["bound_by"] in ("bytes", "operations")
        assert r["max_abs_err"] == 0.0
    widths = {r["params"]["bytes_per_thread"] for r in recs
              if r["probe"] == "row_width"}
    assert widths == set(BYTES_PER_THREAD)


def test_entry_point_needs_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(["gather"]) == 1
    assert "no CUDA device" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        main(["--device", "cpu", "no_such_probe"])


def test_check_template_modes_small():
    errs = probes.check_template_modes(torch.device("cpu"), small=True)
    assert len(errs) == 15 + 3 * (3 * 7 + 2 + 2)
    assert all(e == 0.0 for e in errs.values())


def test_wrappers_check_their_arguments():
    src = torch.zeros((4, 64, 8))
    tab = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="either"):
        row_copy(src, tab, tab, index=tab)
    with pytest.raises(ValueError, match="int32"):
        row_copy(src, tab.long(), tab)
    with pytest.raises(ValueError, match="device"):
        row_copy(src.to("meta"), tab.to("meta"), tab.to("meta"))
    with pytest.raises(ValueError, match="degree 3"):
        window_stream(src, tab[:3], tab[:3], 3, 1)
    with pytest.raises(ValueError, match="syn"):
        window_stream(src, torch.zeros(6, dtype=torch.int32),
                      torch.zeros(6, dtype=torch.int32), 6, 1, out="sum",
                      syn=torch.zeros((1, 64, 8), dtype=torch.int8))
    assert torch.equal(row_copy_plain(src, tab, tab), src[tab.long()])


@pytest.mark.parametrize("probe, k", [("overlap2", 0), ("overlap3", 0),
                                      ("overlap2", 1)])
def test_copy_points_are_found(probe, k):
    """A window stream of one window per block, every block in order, no
    shift and k = 0 is a copy (the points whose library_ms is copy_'s);
    a shift, a permutation or a φ step is not."""
    src = C.randn((4, 64, 8), torch.bfloat16, torch.device("cpu"), seed=1)
    ident = torch.arange(4, dtype=torch.int32)
    zero = torch.zeros_like(ident)
    assert phi_overlap._is_copy(src, ident, zero, 1, k, "sum") == (k == 0)
    assert not phi_overlap._is_copy(src, ident.flip(0), zero, 1, 0, "sum")
    assert not phi_overlap._is_copy(src, ident, zero + 1, 1, 0, "sum")
    rec = phi_overlap.measure(probe, "x:1", {}, torch.device("cpu"),
                              {"name": "cpu", "power_limit": None}, src,
                              ident, zero, 1, k, "aligned")
    assert rec["library_ms"] is None and rec["max_abs_err"] == 0.0


def test_compare_msgs_rule():
    """The one rule chip_smoke.py and the probes hold φ outputs to: signs
    exact; bf16 one ulp on a share <= 1e-4; float8_e5m2 one step on a share
    <= 1e-4; float32 one ulp relative."""
    p = torch.linspace(0.5, 4.0, 20000).to(torch.bfloat16)
    k = p.clone()
    k.view(torch.int16)[0] += 1
    assert perf.compare_msgs("x", k, p)[1] == pytest.approx(1 / 20000)
    k.view(torch.int16)[1:3] += 1
    with pytest.raises(AssertionError, match="share"):
        perf.compare_msgs("x", k, p)
    k = p.clone()
    k.view(torch.int16)[0] += 2
    with pytest.raises(AssertionError, match="more than 1 ulp"):
        perf.compare_msgs("x", k, p)
    with pytest.raises(AssertionError, match="sign"):
        perf.compare_msgs("x", -p, p)
    p8 = p.to(torch.float8_e5m2)
    k8 = p8.clone()
    k8.view(torch.uint8)[0] += 1
    assert perf.compare_msgs("x", k8, p8)[1] == pytest.approx(1 / 20000)
    k8.view(torch.uint8)[0] += 1
    with pytest.raises(AssertionError, match="step"):
        perf.compare_msgs("x", k8, p8)
    f = p.float()
    assert perf.compare_msgs("x", f, f.clone()) == (0.0, 0.0)


def test_bit_identical():
    a = torch.tensor([0.0, 1.0, float("nan")])
    assert perf.bit_identical(a, a.clone().view(3, 1))
    assert not perf.bit_identical(a, torch.tensor([-0.0, 1.0, float("nan")]))
    assert perf.bit_identical(a.double(), a.double().clone())
    assert not perf.bit_identical(torch.arange(3), torch.arange(1, 4))
    with pytest.raises(AssertionError, match="shape|Size"):
        C.assert_bit_equal(a, a.view(3, 1), "x")


def test_card_is_found_by_uuid(monkeypatch):
    """nvidia-smi lists every card of the host; the record takes the line
    of the card torch sees, by UUID, and its name must be torch's."""
    class Props:
        uuid = "bbbb-2"

    class Done:
        stdout = ("GPU-aaaa-1, NVIDIA H100 80GB HBM3, 700.00 W\n"
                  "GPU-bbbb-2, NVIDIA H100 80GB HBM3, 500.00 W\n")

    monkeypatch.setattr(C.subprocess, "run", lambda *a, **kw: Done)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: Props)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda dev: "NVIDIA H100 80GB HBM3")
    assert C.card(torch.device("cuda", 0)) == {
        "name": "NVIDIA H100 80GB HBM3", "power_limit": "500.00 W"}
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda dev: "other")
    with pytest.raises(RuntimeError, match="names card"):
        C.card(torch.device("cuda", 0))
    Props.uuid = "cccc-3"
    with pytest.raises(RuntimeError, match="no card"):
        C.card(torch.device("cuda", 0))


# ---- the window kernels' launch plan and staged runs ------------------------

# (Z, rows per staged block): whole blocks, a partial last block, Z below
# one block, Z = 1, the probes' Z
STAGE_CASES = [(1024, 32), (1024, 64), (256, 64), (100, 64), (100, 32),
               (7, 7), (1, 1), (200, 3), (18432, 16), (174080, 32)]
_SHAPES = sorted({(out, d) for out in ("sum", "loo")
                  for d, _ in K.WINDOW_SHAPES[out]})
SHARED_BYTES = 232448  # shared memory a block can use on an H100


@pytest.mark.parametrize("Z,R", STAGE_CASES)
def test_stage_runs_cover_the_rotated_rows(Z, R):
    """Every block's runs, laid end to end in shared memory, are the rows
    (z0 + i + shift) mod Z, i < n: one run, or two where they pass Z."""
    rng = np.random.default_rng(Z * 7 + R)
    shifts = sorted({0, Z - 1, Z // 2, *rng.integers(0, Z, 6).tolist()})
    blocks = range(0, Z, R) if Z // R <= 64 else [0, R, (Z - 1) // R * R]
    wraps = 0
    for z0 in blocks:
        n = min(R, Z - z0)
        for shift in shifts:
            runs = K.stage_runs(Z, z0, n, shift)
            assert 1 <= len(runs) <= 2
            assert all(0 <= a and 0 < m and a + m <= Z for a, m in runs)
            rows = np.concatenate([np.arange(a, a + m) for a, m in runs])
            np.testing.assert_array_equal(
                rows, (z0 + np.arange(n) + shift) % Z)
            wraps += len(runs) == 2
    assert wraps > 0 or Z == 1


def _staged_model(src, blocks, shifts, degree, out, syn):
    """The staged kernel's data movement in numpy: per block of the plan,
    each window's rows assembled from its runs, then the plain arithmetic
    on the assembled tiles."""
    NB, Z, W = src.shape
    n_nodes = len(blocks) // degree
    plan = K.window_plan("staged", degree, out, Z, W, n_nodes)
    R = plan["stage_rows"]
    assert plan["grid"] == (-(-Z // R), 1, n_nodes)
    tiles = np.empty((n_nodes, degree, Z, W), src.dtype)
    for node in range(n_nodes):
        for z0 in range(0, Z, R):
            n = min(R, Z - z0)
            for s in range(degree):
                at = node * degree + s
                tiles[node, s, z0:z0 + n] = np.concatenate(
                    [src[blocks[at], a:a + m] for a, m in K.stage_runs(
                        Z, z0, n, int(shifts[at]))])
    # the tiles are the windows: the plain version of an identity table
    flat = _t(tiles.reshape(n_nodes * degree, Z, W))
    ident = torch.arange(n_nodes * degree, dtype=torch.int32)
    return window_stream_plain(flat, ident, torch.zeros_like(ident), degree,
                               1, out, False, None if syn is None
                               else _t(syn))


@pytest.mark.parametrize("Z", [256, 100, 33])
@pytest.mark.parametrize("out,degree", _SHAPES)
def test_staged_schedule_reproduces_the_window_stream(Z, out, degree):
    """Windows staged by the plan's blocks and stage_runs, then summed or
    taken leave-one-out, equal the plain window stream bit for bit (φ
    stubbed): the copies land every rotated row where the kernel reads
    it, partial last blocks and wraps included."""
    W, NB = 16, 12
    rng = np.random.default_rng(Z + degree)
    src = rng.standard_normal((NB, Z, W)).astype(np.float32)
    n_nodes = 2
    blocks = rng.permutation(NB)[:n_nodes * degree].astype(np.int32)
    shifts = rng.integers(0, Z, n_nodes * degree).astype(np.int32)
    syn = (rng.integers(0, 2, (n_nodes, Z, W)).astype(np.int8)
           if out == "loo" else None)
    ref = window_stream_plain(_t(src), _t(blocks), _t(shifts), degree, 1,
                              out, False, None if syn is None else _t(syn))
    res = _staged_model(src, blocks, shifts, degree, out, syn)
    np.testing.assert_array_equal(res.numpy().view(np.uint32),
                                  ref.numpy().view(np.uint32))


@pytest.mark.parametrize("mode", sorted(K.MODES))
@pytest.mark.parametrize("out,degree", _SHAPES)
def test_window_plans_fit_the_card(mode, out, degree):
    """Every instantiated shape, at every W the lanes take up to 16384 and
    several Z: the staged rows and the barriers fit the H100's 227 KB of
    shared memory, each window's rows fit one ring stage, the grid's y and
    z stay <= 65,535 and its blocks cover every row and lane once."""
    taken = 0
    for W in range(K.WINDOW_LANES, 16384 + 1, K.WINDOW_LANES):
        for Z, n_nodes, rows in ((1, 1, 1), (100, 3, 7), (18432, 16, 8),
                                 (174080, 65535, 32)):
            plan = K.window_plan(mode, degree, out, Z, W, n_nodes, rows)
            if plan is None:  # only a staged row wider than a stage
                assert mode == "staged" and 2 * W > min(
                    K.STAGE_WINDOW_BYTES,
                    K.STAGE_BLOCK_BYTES // K.stage_count(degree, out))
                continue
            taken += 1
            (bx, by), (gx, gy, gz) = plan["block"], plan["grid"]
            assert gy <= K.GRID_YZ and gz == n_nodes <= K.GRID_YZ
            assert gx < 2**31
            vectors = W // K.WINDOW_LANES
            if mode == "staged":
                R, S = plan["stage_rows"], plan["stages"]
                assert (bx, by, gy) == (K.STAGE_THREADS, 1, 1)
                assert S == K.stage_count(degree, out)
                assert plan["smem"] == S * R * 2 * W
                assert plan["smem"] + 8 * S <= SHARED_BYTES
                assert plan["smem"] <= K.STAGE_BLOCK_BYTES
                # a stage's 8-lane vectors fill the kernel's slots: at most
                # (window bytes / 16) per block
                assert R * 2 * W <= min(K.STAGE_WINDOW_BYTES,
                                        K.STAGE_BLOCK_BYTES // S)
                assert 1 <= R <= min(K.STAGE_MAX_ROWS, Z)
                assert (gx - 1) * R < Z <= gx * R
            else:
                assert bx == min(vectors, K.LANE_THREADS)
                assert by == K.LANE_THREADS // bx and plan["smem"] == 0
                assert (gy - 1) * bx < vectors <= gy * bx
                assert (gx - 1) * by * rows < Z <= gx * by * rows
    assert taken > 0


@pytest.mark.parametrize("mode", sorted(K.MODES))
def test_window_plans_refuse(mode):
    """No launch for a W off the 16-byte lanes, too many nodes, rows
    outside 1..Z (aligned, direct) or a staged row wider than a stage."""
    assert K.window_plan(mode, 6, "loo", 256, 200, 2) is not None
    for W in (0, 4, 12, 36, 201):
        assert K.window_plan(mode, 6, "loo", 256, W, 2) is None
    assert K.window_plan(mode, 1, "sum", 256, 128, K.GRID_YZ + 1) is None
    assert K.window_plan(mode, 1, "sum", 256, 128, 0) is None
    if mode == "staged":
        assert K.window_plan(mode, 1, "sum", 256, 8200, 1) is None
        assert K.window_plan(mode, 6, "loo", 256, 4104, 1) is None
        assert K.window_plan(mode, 1, "sum", 256, 128, 1, rows=999) is not None
    else:
        assert K.window_plan(mode, 1, "sum", 256, 8200, 1) is not None
        assert K.window_plan(mode, 1, "sum", 256, 128, 1, rows=257) is None
        assert K.window_plan(mode, 1, "sum", 256, 128, 1, rows=0) is None


@pytest.mark.parametrize("name,mode,degree,out,Z,W,n", [
    ("overlap2", "aligned", 1, "sum", 1024, 128, 4096),
    ("overlap2 staged", "staged", 1, "sum", 1024, 128, 4096),
    ("overlap4 v1", "aligned", 6, "sum", 1024, 128, 512),
    ("overlap4 v4", "staged", 6, "loo", 1024, 128, 512),
    ("overlap6", "direct", 6, "loo", 18432, 256, 16),
    ("window_read A", "staged", 6, "sum", 174080, 256, 3),
    ("window_read B", "direct", 6, "sum", 174080, 256, 3),
    ("check_template_modes", "staged", 6, "loo", 18432, 256, 16),
    ("ragged card test", "staged", 6, "loo", 256, 200, 2)])
def test_probe_shapes_take_the_vector_kernels(name, mode, degree, out, Z, W,
                                              n):
    """Every probe's full-size shape has a launch; the staged ones hold
    48 KB of rows a block (four blocks an SM) or less."""
    plan = K.window_plan(mode, degree, out, Z, W, n)
    assert plan is not None, name
    assert plan["smem"] <= K.STAGE_BLOCK_BYTES


def test_window_stream_phi_policies():
    """The fast φ exists for live φ at FAST_SHAPES only; on the CPU both
    policies run the one plain version."""
    src = torch.randn((8, 64, 16)).to(torch.bfloat16)
    tab = torch.arange(6, dtype=torch.int32)
    one = torch.arange(1, dtype=torch.int32)
    for degree, out, t in ((1, "sum", one), (6, "loo", tab)):
        a = window_stream(src, t, t, degree, 1, out=out)
        f = window_stream(src, t, t, degree, 1, out=out, phi="fast")
        assert torch.equal(a.view(torch.int16), f.view(torch.int16))
    with pytest.raises(ValueError, match="fast"):
        window_stream(src, tab, tab, 6, 1, phi="fast")  # sum of degree 6
    with pytest.raises(ValueError, match="fast"):
        window_stream(src, one, one, 1, 1, phi_live=False, phi="fast")
    with pytest.raises(ValueError, match="fast"):
        window_stream(src, one, one, 1, 2, phi="fast")
    with pytest.raises(ValueError, match="phi policy"):
        window_stream(src, one, one, 1, 1, phi="rough")


@pytest.mark.parametrize("name", sorted(_kernels.SOURCES))
def test_every_library_builds_with_one_flag_set(monkeypatch, name):
    """Every library, the probes included, builds with the same nvcc flags
    (its instantiations compiled in parallel, --split-compile=0)."""
    seen = {}
    monkeypatch.setattr(_kernels, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_kernels, "build_shared_library",
                        lambda lib, sources, cmd, **kw: seen.update(
                            lib=lib, sources=sources, cmd=cmd) or "built")
    assert _kernels.library_path(name) == "built"
    assert seen == {"lib": name, "sources": _kernels.SOURCES[name],
                    "cmd": ["nvcc", *_kernels.NVCC_FLAGS]}
    assert "--split-compile=0" in _kernels.NVCC_FLAGS


class _MirrorLibrary:
    """A stand-in for the probes library whose launch plans and staged runs
    are the Python mirrors' (``runs_off`` shifts every run start by one)."""

    def __init__(self, runs_off: int = 0):
        self.plan_calls, self.runs_off = 0, runs_off
        self.modes = {v: k for k, v in K.MODES.items()}
        self.outs = {v: k for k, v in K.OUTS.items()}

    def ldpc_probe_window_plan(self, mode, degree, out, Z, W, n, rows, plan):
        self.plan_calls += 1
        p = K.window_plan(self.modes[mode], degree, self.outs[out], Z, W, n,
                          rows)
        if p is None:
            return 1
        plan[0:8] = [*p["block"], *p["grid"], p["smem"], p["stage_rows"],
                     p["stages"]]
        return 0

    def ldpc_probe_stage_runs(self, Z, z0, n, shift, runs):
        got = K.stage_runs(Z, z0, n, shift)
        for r, (start, length) in enumerate(got):
            runs[2 * r], runs[2 * r + 1] = start + self.runs_off, length
        return len(got)


def test_probe_library_is_checked_once_before_its_first_launch(monkeypatch):
    """``kernels.library`` holds the loaded library to the mirrors once;
    a library whose staged runs differ is refused."""
    lib = _MirrorLibrary()
    monkeypatch.setattr(_kernels, "load", lambda name: lib)
    monkeypatch.setattr(K, "_library_checked", False)
    assert K.library() is lib and lib.plan_calls > 0
    calls = lib.plan_calls
    assert K.library() is lib and lib.plan_calls == calls
    bad = _MirrorLibrary(runs_off=1)
    monkeypatch.setattr(_kernels, "load", lambda name: bad)
    monkeypatch.setattr(K, "_library_checked", False)
    with pytest.raises(RuntimeError, match="stage_runs"):
        K.library()


def test_probe_timers(monkeypatch):
    """``timed`` is the decode kernels' single-launch timer, the caller's
    set-up unchanged; ``queued_timed`` spins the card before each run, after
    the caller's set-up; both return None on the CPU."""
    calls = []
    monkeypatch.setattr(perf, "cuda_ms",
                        lambda fn, reps, setup=None: calls.append(
                            (fn, reps, setup)) or 1.5)
    slept = []
    monkeypatch.setattr(torch.cuda, "_sleep", slept.append)
    monkeypatch.setattr(C, "WARMUP_S", 0.0)
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    fn, order = (lambda: None), []
    assert C.timed(cpu, fn) is None and C.queued_timed(cpu, fn) is None
    assert calls == []
    assert C.timed(cuda, fn, 3, order.append) == 1.5
    assert calls[-1] == (fn, 3, order.append)
    assert C.queued_timed(cuda, fn, 4, lambda: order.append("setup")) == 1.5
    _, reps, queued = calls[-1]
    queued()
    assert reps == 4 and order == ["setup"] and slept == [C.QUEUE_CYCLES]
