"""The benchmark's own alist reading and frame bank: the graph equal to
the port's parse of the same file, padded rows read alike, the bank's
syndromes those of its bits under the alist, the punctured tail without a
channel value, and the same seed giving the same frames."""

import numpy as np
import pytest
import torch

from pbcore import bank
from pbcore.graph import Buckets, load_graph, parse_alist


@pytest.mark.parametrize("family", ["grouped", "regular"])
def test_graph_equals_the_ports_parse(small_codes, family, tmp_path):
    from ldpc_decoder_tpu_torch.codes.alist import parse_alist as port_parse

    _, _, path = small_codes[family]
    g, p = parse_alist(path), port_parse(path)
    assert (g.n_vars, g.n_checks, g.n_punctured) == (
        p.n_vars, p.n_checks, p.n_erased_vars)
    assert np.array_equal(g.adjacency, p.check_adjacency)
    assert np.array_equal(g.var_degrees, p.var_degrees)
    cached = load_graph(path, str(tmp_path))
    again = load_graph(path, str(tmp_path))
    assert np.array_equal(cached.adjacency, again.adjacency)
    assert len(list(tmp_path.glob("graph-*.npz"))) == 1


def test_padded_rows(tmp_path):
    f = tmp_path / "pad.alist"
    f.write_text("#e=1\n2 4\n3 2\n3 2\n1 1 2 1\n1 2 3\n3 4 0\n")
    g = parse_alist(str(f))
    assert g.n_punctured == 1
    assert g.adjacency.tolist() == [0, 1, 2, 2, 3]
    f.write_text("2 4\n3 2\n3 2\n1 1 2 2\n1 2 3\n3 4 0\n")
    with pytest.raises(ValueError):
        parse_alist(str(f))


@pytest.mark.parametrize("family,channel,noise", [("grouped", "awgn", 0.9),
                                                  ("regular", "bsc", 0.05)])
def test_bank_syndromes_and_values(small_codes, family, channel, noise):
    from ldpc_decoder_tpu_torch.codes.code import compute_syndrome

    code, _, path = small_codes[family]
    g = parse_alist(path)
    b = Buckets.of(g, "cpu")
    gen = bank.generator(2**31 + 12345, "cpu")
    torch.manual_seed(0)
    bits = torch.randint(0, 2, (g.n_vars, 7), dtype=torch.int8)
    assert np.array_equal(b.syndromes(bits).numpy(),
                          compute_syndrome(code, bits.numpy()))
    v, s = bank.make_block(g, b, channel, noise, 9, gen, "cpu")
    assert v.dtype == torch.float32 and s.dtype == torch.int8
    if g.n_punctured:
        assert not v[g.n_vars - g.n_punctured:].any()
    sent = v[:g.n_vars - g.n_punctured]
    hard = (sent > 0).to(torch.int8)
    if channel == "bsc":
        assert set(sent.abs().unique().tolist()) == {1.0}
    v2, s2 = bank.make_block(g, b, channel, noise, 9,
                             bank.generator(2**31 + 12345, "cpu"), "cpu")
    assert torch.equal(v, v2) and torch.equal(s, s2)
    assert hard.float().mean() == pytest.approx(0.5, abs=0.1)


def test_sample_is_drawn_from_the_seed():
    a = bank.sample_frames(2**33 + 1, 2048, 256)
    assert np.array_equal(a, bank.sample_frames(2**33 + 1, 2048, 256))
    assert a.size == 256 and np.unique(a).size == 256
    assert not np.array_equal(a, bank.sample_frames(2**33 + 2, 2048, 256))
