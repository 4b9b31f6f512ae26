"""The plain reference against the port's plain decode on the CPU, in
float32 on small codes of both families: the same words and the same
iteration counts for every frame, those decoded from the start of a call
and those that refill a lane."""

import os

import numpy as np
import pytest
import torch

from pbcore import bank, cell, program
from pbcore.graph import Buckets, parse_alist


@pytest.mark.parametrize("name", ["small-awgn", "small-bsc"])
def test_reference_equals_the_ports_plain_decode(small_bench, name):
    cfg = cell.config(small_bench, name)
    prog = program.load(cfg, "cpu")
    g = parse_alist(program.alist_path(cfg))
    b = Buckets.of(g, "cpu")
    v, s = bank.make_block(g, b, cfg["channel"], cfg["noise"], 48,
                           bank.generator(99, "cpu"), "cpu")
    words, stats = prog.decoder.decode(prog.dyn, 48, v.numpy(), s.numpy())
    first_fill = torch.arange(48) < cfg["B"]
    ref_words, ref_counts, solved = cell.reference("flood_f32").decode(
        b, v, s, first_fill, cfg)
    assert np.array_equal(ref_counts.numpy(), stats.iterations)
    assert np.array_equal(ref_words.numpy().view(np.uint32), words)
    assert len(set(stats.iterations.tolist())) > 1
    assert np.array_equal(solved.numpy(),
                          stats.iterations < cfg["max_iterations"])


def test_a_code_named_by_its_constructor_and_an_alist_path(tmp_path):
    """A configuration of a code with no QC structure, made by the port's
    constructor from arguments, its alist a path relative to the
    checkout: the program on the general path against the reference, on
    the frames of one batch (the general path counts a refilled lane's
    iterations by another rule than the QC families, which the reference
    follows)."""
    from ldpc_decoder_tpu_torch.codes.generate import make_regular_code

    path = tmp_path / "general.alist"
    make_regular_code(192, 3, 6, seed=9).to_alist(str(path))
    cfg = {"code_entry": "codes.generate.make_regular_code",
           "code_args": [192, 3, 6], "code_kwargs": {"seed": 9},
           "code_alist": os.path.relpath(path, program.ROOT),
           "channel": "awgn", "noise": 0.7, "algorithm": "sum-product",
           "message_dtype": "float32", "B": 32, "check_period": 2,
           "first_check": 4, "max_iterations": 30, "phi_floor": 1e-5}
    prog = program.load(cfg, "cpu")
    assert prog.code_how == "built"
    g = parse_alist(program.alist_path(cfg))
    assert (g.n_vars, g.n_checks) == (192, 96)
    b = Buckets.of(g, "cpu")
    v, s = bank.make_block(g, b, cfg["channel"], cfg["noise"], 32,
                           bank.generator(5, "cpu"), "cpu")
    words, stats = prog.decoder.decode(prog.dyn, 32, v.numpy(), s.numpy())
    ref_words, ref_counts, _ = cell.reference("flood_f32").decode(
        b, v, s, torch.ones(32, dtype=torch.bool), cfg)
    assert np.array_equal(ref_counts.numpy(), stats.iterations)
    assert np.array_equal(ref_words.numpy().view(np.uint32), words)
    assert len(set(stats.iterations.tolist())) > 1


def test_unpack_inverts_the_packing():
    from pbcore.drive import unpack

    bits = (torch.rand(70, 5) < 0.5).to(torch.int8)
    words = cell.reference("flood_f32").pack(bits)
    assert torch.equal(unpack(words, 70), bits)
