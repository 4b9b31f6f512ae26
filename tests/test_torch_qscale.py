"""The int8 min-sum qscale range: the port's passes against JAX's at its edges.

``StaticParams`` (and so the CLI's ``--qscale``) takes a power of two in
[2^-121, 2^125]. Over that range every step |q| / qscale (|q| <= 127) and
1/qscale are normal float32 values: nothing overflows and nothing lands in
the subnormals, which XLA:CPU flushes to zero. So the integer order of
|q|, which the CUDA check kernels scan, is the order of the values, and
JAX's passes give the same messages as the port's.

Beyond it the two part: at 2^-122 the steps |q| >= 64 dequantize to inf;
at 2^126, α · 2^-126 (α < 1) is a subnormal, which XLA:CPU flushes to 0
where the port rounds it and quantizes it to one step; at 2^127, 1/qscale
itself is a subnormal, and JAX dequantizes every message to 0. The tests
here hold the port's plain passes and the numpy model of the check kernel
(``ops/minsum_model.py``) to the JAX package's Pallas passes (interpret
mode, on the CPU) at both edges, bitwise, on int8 messages over the full
range [-127, 127], and show the first difference past the upper edge.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from ldpc_decoder_tpu.codes.protographs import p41_code as jax_p41  # noqa: E402
from ldpc_decoder_tpu.ops import qc_pallas_grouped as jg  # noqa: E402
from ldpc_decoder_tpu.ops.qc_decode import (  # noqa: E402
    QCDecodeTables as JaxQCDecodeTables,
)

from ldpc_decoder_tpu_torch.cli import main  # noqa: E402
from ldpc_decoder_tpu_torch.codes.qc import (  # noqa: E402
    make_qc_code,
    write_qc_alist,
)
from ldpc_decoder_tpu_torch.convert import (  # noqa: E402
    grouped_state_from_jax,
    grouped_state_to_jax,
    structure_from_numpy,
)
from ldpc_decoder_tpu_torch.ops import minsum_model  # noqa: E402
from ldpc_decoder_tpu_torch.ops import qc_grouped as qg  # noqa: E402
from ldpc_decoder_tpu_torch.ops.qc_decode import (  # noqa: E402
    QCDecodeTables,
    dequantize_msgs,
    resolve_minsum_alpha,
)
from ldpc_decoder_tpu_torch.runtime.params import StaticParams  # noqa: E402

B = 8
CLAMP = 20.0
EDGES = {"low": 2.0**-121, "high": 2.0**125}
OUTSIDE = {"below": 2.0**-122, "above": 2.0**126, "far above": 2.0**127}
# (alpha, beta): offset min-sum at the defaults, and a per-degree α table
# with no offset (both bitwise against XLA:CPU: its fused α·m − β differs
# only when both are in play)
RULES = {"offset": (1.0, 0.5),
         "alpha-table": (((3, 0.8), (6, 0.75), (7, 0.75), (0, 0.8)), 0.0)}
INT8_MINSUM = dict(message_dtype="int8", algorithm="min-sum")


@pytest.fixture(scope="module")
def grouped():
    jcode, js = jax_p41(Z=128, m=4, coarse=64, fine_mod=16)
    jt = jg.GroupedQCPallasTables.from_qc_tables(
        JaxQCDecodeTables.from_structure(js, jcode.n_erased_vars), 1)
    s = structure_from_numpy(js.Z, js.n_base_rows, js.n_base_cols,
                             js.edge_row, js.edge_col, js.edge_shift)
    t = qg.GroupedQCTables.from_qc_tables(
        QCDecodeTables.from_structure(s, jcode.n_erased_vars, "cpu"))
    return dict(jt=jt, t=t)


def _int8(rng, shape):
    """int8 messages over the whole range a pass stores, ties and 0."""
    return rng.integers(-127, 128, shape).astype(np.int8)


def _cn(grouped, qscale, rule):
    """(msgs_v, syndromes, the JAX check pass's r_c, the port's)."""
    jt, t = grouped["jt"], grouped["t"]
    alpha, beta = RULES[rule]
    rng = np.random.default_rng(21)
    mv = _int8(rng, (t.nb, t.Z, B))
    syn = (rng.random((t.R, t.Z, B)) < 0.5).astype(np.int8)
    mv_j, rc_j = grouped_state_to_jax(mv, np.zeros_like(mv), jt, t)
    out_j = jg.cn_pass_grouped(jnp.asarray(mv_j), jnp.asarray(syn),
                               jnp.asarray(rc_j), jt, alg="min-sum",
                               beta=beta, alpha=alpha, qscale=qscale)
    _, ref = grouped_state_from_jax(mv_j, np.asarray(out_j), jt, t)
    out = qg.cn_pass_grouped_minsum(
        torch.from_numpy(mv), torch.from_numpy(syn),
        torch.empty((t.nb, t.Z, B), dtype=torch.int8), t, alpha, beta,
        qscale)
    return mv, syn, ref, out.numpy()


@pytest.mark.parametrize("rule", sorted(RULES))
@pytest.mark.parametrize("edge", sorted(EDGES))
def test_grouped_cn_minsum_matches_jax_at_edges(grouped, edge, rule):
    _, _, ref, out = _cn(grouped, EDGES[edge], rule)
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("rule", sorted(RULES))
@pytest.mark.parametrize("edge", sorted(EDGES))
def test_grouped_cn_minsum_model_matches_jax_at_edges(grouped, edge, rule):
    """The check kernel's numpy model: its integer scan, its stored
    magnitudes and their sign."""
    t = grouped["t"]
    qscale = EDGES[edge]
    alpha, beta = RULES[rule]
    mv, syn, ref, _ = _cn(grouped, qscale, rule)
    mv_t = torch.from_numpy(mv)
    out = torch.empty_like(mv_t)
    for g in t.row_groups:
        d, n = g.degree, g.count
        sl = slice(g.block_start, g.block_start + n * d)
        rows = qg._rotated(mv_t, t.cn_src[sl], t.cn_shift[sl], t.Z)
        m, kind = minsum_model.to_bits(rows.view(n, d, t.Z, B).transpose(0, 1))
        for packed in (False, True):
            fn = (minsum_model.check_rows_packed if packed
                  else minsum_model.check_rows)
            # the packed path's table of all 256 magnitudes holds |q| = 128
            # (q = -128, which no store makes), inf at 2^-121 as on the card
            with np.errstate(over="ignore"):
                got = fn(m, syn[g.node_start:g.node_start + n], kind,
                         resolve_minsum_alpha(alpha, d), beta, qscale)
            out[sl].view(n, d, t.Z, B).copy_(
                minsum_model.from_bits(np.swapaxes(got, 0, 1), kind))
            np.testing.assert_array_equal(out.numpy()[sl], ref[sl])


@pytest.mark.parametrize("emit", [False, True])
@pytest.mark.parametrize("edge", sorted(EDGES))
def test_grouped_vn_minsum_matches_jax_at_edges(grouped, edge, emit):
    """Totals of full-range steps (at 2^-121 they overflow to inf, alike on
    both sides: the same left-to-right sum), clipped and quantized."""
    jt, t = grouped["jt"], grouped["t"]
    qscale = EDGES[edge]
    rng = np.random.default_rng(22)
    rc, mv = _int8(rng, (t.nb, t.Z, B)), _int8(rng, (t.nb, t.Z, B))
    llr = torch.from_numpy((rng.standard_normal((t.C, t.Z, B)) * 12).astype(
        np.float32)).to(torch.bfloat16)
    mv_j, rc_j = grouped_state_to_jax(mv, rc, jt, t)
    out_j, bits_j = jg.vn_pass_grouped(
        jnp.asarray(rc_j), jnp.asarray(llr.float().numpy(), jnp.bfloat16),
        jnp.asarray(mv_j), jt, emit_bits=emit, alg="min-sum", clamp=CLAMP,
        qscale=qscale)
    ref, _ = grouped_state_from_jax(np.asarray(out_j), rc_j, jt, t)
    bits = torch.full((t.C, t.Z, B), -1, dtype=torch.int8) if emit else None
    out = qg.vn_pass_grouped_minsum(torch.from_numpy(rc), llr,
                                    torch.from_numpy(mv.copy()), t, CLAMP,
                                    qscale, bits=bits)
    np.testing.assert_array_equal(out.numpy(), ref)
    if emit:
        np.testing.assert_array_equal(bits.numpy(), np.asarray(bits_j))


@pytest.mark.parametrize("edge", sorted(EDGES))
def test_steps_are_exact_normals_at_edges(edge):
    """Every step and 1/qscale is a finite normal float32 whose integer
    order is the order of the values."""
    qscale = EDGES[edge]
    q = torch.arange(-127, 128, dtype=torch.int32).to(torch.int8)
    f = dequantize_msgs(q, qscale).numpy()
    nz = f[f != 0]
    assert np.isfinite(f).all()
    assert (np.abs(nz) >= np.finfo(np.float32).tiny).all()
    np.testing.assert_array_equal(f.astype(np.float64) * qscale,
                                  q.numpy().astype(np.float64))
    a = np.abs(q.numpy().astype(np.int32))
    np.testing.assert_array_equal(a[:, None] < a[None, :],
                                  np.abs(f)[:, None] < np.abs(f)[None, :])


def test_jax_flushes_past_the_upper_edge(grouped):
    """At 2^126 the α table's α·2^-126 is a subnormal: XLA:CPU flushes it
    to 0, the port quantizes it to one step, so the passes differ (the
    reason the range stops at 2^125)."""
    _, _, ref, out = _cn(grouped, OUTSIDE["above"], "alpha-table")
    assert (out != ref).any()
    assert (np.abs(out.astype(np.int32) - ref.astype(np.int32)) <= 1).all()


@pytest.mark.parametrize("edge", sorted(EDGES))
def test_static_params_accept_edges(edge):
    assert StaticParams(minsum_qscale=EDGES[edge],
                        **INT8_MINSUM).minsum_qscale == EDGES[edge]


@pytest.mark.parametrize("qscale", [*OUTSIDE.values(), 3.0, 0.0, -4.0],
                         ids=[*OUTSIDE, "not a power of two", "zero",
                              "negative"])
def test_static_params_refuse_outside(qscale):
    with pytest.raises(ValueError, match=r"power of two in \[2\^-121, "
                                         r"2\^125\]"):
        StaticParams(minsum_qscale=qscale, **INT8_MINSUM)


@pytest.fixture(scope="module")
def small_alist(tmp_path_factory):
    path = tmp_path_factory.mktemp("qscale") / "qc36.alist"
    code, s = make_qc_code(np.ones((3, 6), np.int8), Z=32, seed=3)
    write_qc_alist(code, s, str(path))
    return str(path)


@pytest.mark.parametrize("qscale,rc", [
    (EDGES["low"], 0), (EDGES["high"], 0), (OUTSIDE["below"], 1),
    (OUTSIDE["above"], 1)], ids=["low", "high", "below", "above"])
def test_cli_qscale_range(small_alist, capsys, qscale, rc):
    """The CLI decodes at both edges (int8 min-sum, a small QC code on the
    CPU) and refuses past them with StaticParams' message."""
    argv = ["-f", small_alist, "-c", "1", "-n", "0.6", "-p", "3", "-m", "1",
            "-e", "15", "-i", "10", "-r", "1", "--dtype", "int8",
            "--algorithm", "min-sum", "--qscale", repr(qscale),
            "--device", "cpu", "--memory-bytes", str(1 << 30)]
    assert main(argv) == rc
    out = capsys.readouterr().out
    if rc:
        assert "power of two in [2^-121, 2^125]" in out
    else:
        assert "Bit error rate (BER):" in out
