"""Row 11: the grouped check and variable kernels writing fresh outputs.

Replaces ``scripts/debug_grouped.py:24`` ``cn_pass_noalias`` and ``:71``
``vn_pass_noalias`` (``pallas_call`` at ``:58`` and ``:111``), driven by
``run_noalias:132``: the grouped Pallas passes with per-group outputs
assembled by concatenation instead of aliased into the recycled arrays, to
clear ``input_output_aliases`` of a convergence fault. Here the port's own
grouped kernels (``csrc/qc_grouped.cu``, through
:func:`~ldpc_decoder_tpu_torch.ops.qc_grouped.cn_pass_grouped` and
:func:`~ldpc_decoder_tpu_torch.ops.qc_grouped.vn_pass_grouped`) write each
pass into a fresh tensor instead of rewriting ``r_c`` and ``msgs_v`` in
place (the port's design): the kernels write at ``block_start + node·D`` of
whatever pointer they are given, so no kernel changes. With ``assemble``,
each pass's output is then rebuilt as a ``torch.cat`` of its group slices,
the script's assembly.

The variable pass skips p41's degree-1 group on non-emit iterations (its
messages φ(llr) do not change). In a fresh tensor those blocks would be
garbage, so they are carried over from the previous messages (a copy of
the degree-1 blocks) rather than recomputed by ``include_d1=True``, which
would store the kernel's φ(llr) where the init stored the plain version's.

At p41 x B = 256, bfloat16, k = 14 iterations from a real decode state, the
messages, hard bits and parity flags must be bit-identical to the in-place
run (:func:`~ldpc_decoder_tpu_torch.ops.qc_grouped.run_iterations_qc_grouped`).
"""

from __future__ import annotations

import numpy as np
import torch

from ldpc_decoder_tpu_torch.ops import qc_grouped as qg
from ldpc_decoder_tpu_torch.probes import _common as C
from ldpc_decoder_tpu_torch.runtime import perf

REPLACES = "scripts/debug_grouped.py:24"
K_ITERATIONS = 14
SIGMA = 0.94


def _assembled(out: torch.Tensor, groups, assemble: bool) -> torch.Tensor:
    if not assemble:
        return out
    return torch.cat([out[g.block_start : g.block_start + g.count * g.degree]
                      for g in groups])


def run_iterations_fresh(msgs, llr, syn, tables: qg.GroupedQCTables, k: int,
                         assemble: bool = False, plain: bool = False,
                         phi: str = "fast"):
    """k flood iterations like :func:`~ldpc_decoder_tpu_torch.ops.qc_grouped.
    run_iterations_qc_grouped` (no fresh lanes), every pass into a fresh
    output; ``plain`` takes the plain passes, else the kernels with the
    ``phi`` policy. Returns ((msgs_v, r_c), bits, violated); ``msgs`` is
    left as it was."""
    if plain:
        cn, vn, parity = (qg.cn_pass_plain, qg.vn_pass_plain,
                          qg.parity_pass_plain)
    else:
        def cn(*a, **kw):
            return qg.cn_pass_grouped(*a, **kw, _phi=phi)

        def vn(*a, **kw):
            return qg.vn_pass_grouped(*a, **kw, _phi=phi)

        parity = qg.parity_pass_grouped
    msgs_v, r_c = msgs
    d1 = [slice(g.block_start, g.block_start + g.count)
          for g in tables.col_groups if g.degree == 1]
    bits = None
    for it in range(k):
        r_c = _assembled(cn(msgs_v, syn, torch.empty_like(r_c), tables),
                         tables.row_groups, assemble)
        fresh = torch.empty_like(msgs_v)
        if it == k - 1:  # the emit iteration rewrites every group
            bits = torch.empty((tables.C, tables.Z, llr.shape[-1]),
                               dtype=torch.int8, device=llr.device)
        else:
            for sl in d1:
                fresh[sl] = msgs_v[sl]
        vn(r_c, llr, fresh, tables, bits=bits)
        msgs_v = _assembled(fresh, tables.col_groups, assemble)
    return (msgs_v, r_c), bits, parity(bits, syn, tables)


def lane_state(dev, code, s, batch, B: int):
    """Tables and a real decode state four iterations in, from the first B
    frames of ``batch`` (as chip_smoke.py's phase 5 builds one)."""
    from ldpc_decoder_tpu_torch.channels import BIAWGNChannel
    from ldpc_decoder_tpu_torch.ops.qc_decode import QCDecodeTables

    t = qg.GroupedQCTables.from_qc_tables(
        QCDecodeTables.from_structure(s, code.n_erased_vars, dev))
    vals = torch.from_numpy(np.ascontiguousarray(
        batch.values[t.vn_order.cpu().numpy(), :B])).to(dev)
    llr = BIAWGNChannel(SIGMA).llr_from_channel(vals).masked_fill(
        t.erased_mask_sorted, 0.0).to(torch.bfloat16).view(t.C, t.Z, B)
    syn = torch.from_numpy(np.ascontiguousarray(
        batch.syndromes[t.cn_order.cpu().numpy(), :B])).to(dev).view(
        t.R, t.Z, B)
    msgs = qg.init_messages_qc_grouped(llr, t, torch.bfloat16)
    msgs, _, _ = qg.run_iterations_qc_grouped(msgs, llr, syn, t, 4)
    return t, llr, syn, msgs


def superstep_bytes(t: qg.GroupedQCTables, B: int, k: int) -> int:
    """Unique bytes of k bfloat16 iterations and the parity check: k check
    passes, k − 1 variable passes without the degree-1 group, the emit pass
    over every group (llr read, hard bits written) and the parity pass."""
    p = perf.grouped_bytes(t, B, 2, 2)
    blk = t.Z * B
    emit = 2 * t.nb * blk * 2 + t.C * blk * 2 + t.C * blk + 8 * t.nb
    return k * p["cn"] + (k - 1) * p["vn"] + emit + p["parity"]


def _snapshot(msgs):
    return tuple(x.clone() for x in msgs)


def run(dev: torch.device, small: bool = False, headline: bool = False,
        card: dict | None = None, code=None, structure=None,
        batch=None) -> list[dict]:
    """Fresh outputs, then fresh outputs assembled by concatenation, each
    bit-identical to the in-place run, with the in-place run's time beside
    them (headline: fresh outputs). ``code``, ``structure``, ``batch``: the
    p41 code and frames when the caller has them."""
    from ldpc_decoder_tpu_torch.channels import BIAWGNChannel
    from ldpc_decoder_tpu_torch.codes.protographs import p41_code
    from ldpc_decoder_tpu_torch.runtime.datagen import create_data

    card = card or C.card(dev)
    B = 8 if small else 256
    if code is None:
        code, structure = (p41_code(Z=128, m=4, coarse=64, fine_mod=16)
                           if small else p41_code())
    if batch is None:
        # on the card's host the native library, asked for by name (no
        # fallback to numpy); on the CPU create_data's default
        batch = create_data(code, BIAWGNChannel(SIGMA), 0, B,
                            backend="native" if dev.type == "cuda"
                            else "auto")
    t, llr, syn, msgs = lane_state(dev, code, structure, batch, B)
    k = K_ITERATIONS

    # one iteration, kernel against the plain passes (sum-product rule, on
    # the kernels' accurate-φ instantiation, the plain version's φ)
    (mk, rk), bk, fk = run_iterations_fresh(msgs, llr, syn, t, 1,
                                            phi="accurate")
    (mp, rp), bp, fp = run_iterations_fresh(msgs, llr, syn, t, 1, plain=True)
    err = max(C.assert_msgs_match(rk, rp, "noalias r_c vs plain"),
              C.assert_msgs_match(mk, mp, "noalias msgs_v vs plain"))
    C.assert_bit_equal(bk, bp, "noalias bits vs plain")
    C.assert_bit_equal(fk, fp, "noalias flags vs plain")
    del mk, rk, mp, rp

    # k iterations: fresh (and assembled) against in place, bit for bit
    ref_msgs, ref_bits, ref_flags = qg.run_iterations_qc_grouped(
        _snapshot(msgs), llr, syn, t, k)
    for assemble in (False, True):
        (mv, rc), bits, flags = run_iterations_fresh(msgs, llr, syn, t, k,
                                                     assemble=assemble)
        what = f"noalias (assemble={assemble})"
        C.assert_bit_equal(mv, ref_msgs[0], f"{what} msgs_v")
        C.assert_bit_equal(rc, ref_msgs[1], f"{what} r_c")
        C.assert_bit_equal(bits, ref_bits, f"{what} bits")
        C.assert_bit_equal(flags, ref_flags, f"{what} flags")
    del ref_msgs

    # in place from the same state every run (restored outside the clock):
    # a state left to converge run after run takes φ's cheap branch more
    # often and times faster
    state = _snapshot(msgs)
    in_place_ms = C.timed(
        dev, lambda: qg.run_iterations_qc_grouped(state, llr, syn, t, k),
        setup=lambda: [x.copy_(y) for x, y in zip(state, msgs)])
    blocks = sum(g.count * g.degree for g in t.col_groups if g.degree > 1)
    n_ops = perf.OPS_PER_MESSAGE * (k * t.nb + (k - 1) * blocks + t.nb) * t.Z * B
    records = []
    for assemble in (False,) if headline else (False, True):
        records.append(C.record(
            "noalias", REPLACES,
            {"code": "p41", "Z": t.Z, "B": B, "dtype": "bfloat16",
             "iterations": k, "outputs": "fresh, assembled by torch.cat"
             if assemble else "fresh",
             "degree1": "carried over"},
            superstep_bytes(t, B, k), n_ops, card,
            ms=C.timed(dev, lambda: run_iterations_fresh(
                msgs, llr, syn, t, k, assemble=assemble)),
            plain_ms=C.timed(dev, lambda: run_iterations_fresh(
                msgs, llr, syn, t, k, plain=True), reps=1)
            if headline else None,
            max_abs_err=err, in_place_ms=in_place_ms))
    return records
