"""The import check: JAX and the JAX package are told from the port by
whole top-level names; what a run loads holds neither, and the reference
loads nothing of the program."""

import os
import subprocess
import sys

from pbcore.imports import forbidden_loaded

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_names_are_compared_whole():
    assert forbidden_loaded(["ldpc_decoder_tpu_torch.runtime",
                             "ldpc_decoder_tpu_torch", "jaxtyping"]) == []
    assert forbidden_loaded(["ldpc_decoder_tpu.ops", "jax.numpy", "flax",
                             "jaxlib.xla"]) == [
        "flax", "jax", "jaxlib", "ldpc_decoder_tpu"]


def _loaded(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", f"import sys; sys.path.insert(0, {BENCH!r}); "
         f"{code}; print(' '.join(sorted(sys.modules)))"],
        capture_output=True, text=True, check=True, cwd=os.path.dirname(BENCH))
    return set(out.stdout.split())


def test_a_run_loads_neither_jax_nor_the_jax_package():
    mods = _loaded("import run, readings; from pbcore import cell, program; "
                   "program._port(); import ldpc_decoder_tpu_torch.runtime."
                   "decoder, ldpc_decoder_tpu_torch.codes.samples; "
                   "[cell.reader(m['name'], k) for k in ('per_layer', "
                   "'end_to_end') for m in cell.benchmark()[k]]; "
                   "[cell.entry(e) for e in ('pool', 'stream')]; "
                   "[cell.channel(c) for c in ('awgn', 'bsc')]")
    assert "ldpc_decoder_tpu_torch" in mods
    assert forbidden_loaded(mods) == []


def test_the_reference_loads_nothing_of_the_program():
    mods = _loaded("from pbcore import cell, graph, bank; "
                   "cell.reference('flood_f32'); "
                   "[cell.channel(c) for c in ('awgn', 'bsc')]")
    assert not {m for m in mods if m.split('.')[0].startswith('ldpc')}
