"""The general sum-product kernels' φ policy and vector width, on the CPU.

The general check and variable kernels (csrc/general.cuh) take φ as a
policy, as the QC ones do: the decoder runs the fast φ (MUFU and FMA), and
the accurate one is reachable only through the internal keyword-only
``_phi`` of ``cn_pass_general``/``vn_pass_general`` (that no runner
passes it is checked in tests/test_torch_phi_fast.py). On CPU tensors both
policies take the one plain version. Each launch takes V lanes per thread
(``_kernels.lanes_per_thread``) where the rows are aligned to the vector,
else one. The kernels themselves run on the card only
(tests/test_torch_cuda.py).
"""

from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ldpc_decoder_tpu_torch.codes.compiled import compile_code  # noqa: E402
from ldpc_decoder_tpu_torch.codes.generate import (  # noqa: E402
    make_irregular_code,
)
from ldpc_decoder_tpu_torch.ops import _kernels  # noqa: E402
from ldpc_decoder_tpu_torch.ops import general as G  # noqa: E402

CSRC = Path(__file__).resolve().parents[1] / "ldpc_decoder_tpu_torch" / "csrc"


def _state(B=8, seed=2):
    """A small multi-bucket code (degree-1 variables and checks) and a
    random float32 state of B lanes on the CPU."""
    t = G.GeneralTables.from_compiled(compile_code(make_irregular_code(
        120, 60, {1: 0.1, 2: 0.3, 3: 0.4, 4: 0.2}, {1: 0.1, 5: 0.1, 6: 0.8},
        seed=5)), "cpu")
    rng = np.random.default_rng(seed)

    def rand(rows, scale):
        return torch.from_numpy(
            (rng.standard_normal((rows, B)) * scale).astype(np.float32))

    syn = torch.from_numpy((rng.random((t.n_checks, B)) < 0.5).astype(
        np.int8))
    return t, rand(t.n_edges, 4), rand(t.n_edges, 4), rand(t.n_vars, 3), syn


@pytest.mark.parametrize("emit", [False, True])
@pytest.mark.parametrize("phi", ["fast", "accurate"])
def test_general_phi_keyword_on_cpu_is_the_plain_version(phi, emit):
    """On CPU tensors both policies take the general path's one plain
    version, with and without emit."""
    t, mv, rc, llr, syn = _state()
    got = G.cn_pass_general(mv, syn, torch.empty_like(rc), t, _phi=phi)
    assert torch.equal(got, G.cn_pass_general_plain(
        mv, syn, torch.empty_like(rc), t))
    bk, bp = (torch.full((t.n_vars, mv.shape[-1]), -1, dtype=torch.int8)
              for _ in range(2))
    out = G.vn_pass_general(rc, llr, mv.clone(), t,
                            bits=bk if emit else None, _phi=phi)
    want = G.vn_pass_general_plain(rc, llr, mv.clone(), t,
                                   bits=bp if emit else None)
    assert torch.equal(out, want) and torch.equal(bk, bp)


@pytest.mark.parametrize("phi", ["exact", "tanh", "FAST", ""])
def test_general_phi_keyword_refuses_unknown_policy(phi):
    t, mv, rc, llr, syn = _state()
    with pytest.raises(ValueError, match="phi policy"):
        G.cn_pass_general(mv, syn, torch.empty_like(rc), t, _phi=phi)
    with pytest.raises(ValueError, match="phi policy"):
        G.vn_pass_general(rc, llr, mv.clone(), t, _phi=phi)


# lanes per thread at the general path's shapes: (dtype, B) -> {degree: V}
GENERAL_LANES = {
    (torch.float32, 384): {1: 4, 3: 4, 6: 4, 32: 2},
    (torch.float32, 768): {1: 4, 3: 4, 6: 4, 32: 2},
    (torch.float32, 40): {1: 4, 3: 4, 6: 4, 32: 2},
    (torch.float32, 37): {1: 1, 3: 1, 6: 1, 32: 1},
    (torch.bfloat16, 384): {1: 8, 3: 8, 6: 8, 32: 2},
    (torch.bfloat16, 768): {1: 8, 3: 8, 6: 8, 32: 2},
    (torch.bfloat16, 40): {1: 8, 3: 8, 6: 8, 32: 2},
    (torch.bfloat16, 37): {1: 1, 3: 1, 6: 1, 32: 1},
}


@pytest.mark.parametrize("dtype,B", sorted(GENERAL_LANES, key=str))
def test_general_lanes_per_thread(dtype, B):
    for d, v in GENERAL_LANES[dtype, B].items():
        assert _kernels.lanes_per_thread(B, dtype, d) == v, d
        assert v == 1 or v == _kernels.vec_lanes(dtype, d)


def test_general_lanes_follow_alignment():
    """A general launch on a tensor whose base is off the vector boundary
    takes one lane per thread, the hard bits included."""
    a = torch.zeros(8192, dtype=torch.bfloat16)
    bits = torch.zeros(1024, dtype=torch.int8)
    assert _kernels._lanes(384, 6, a, a[384:], bits) == 8
    assert _kernels._lanes(384, 6, a[1:]) == 1
    assert _kernels._lanes(384, 3, a, None, a, bits[3:]) == 1


def test_general_sources_split_by_policy():
    """The general library compiles its fast and accurate instantiations
    in two sources, in parallel (beside a third, the min-sum check
    kernel's, and a fourth, every float8_e5m2 instantiation), and its
    kernels' header is hashed into every build key."""
    assert [Path(f).name for f in _kernels.SOURCES["general"]] == [
        "general.cu", "general_accurate.cu", "general_minsum.cu",
        "general_fp8.cu"]
    assert "general.cuh" in {Path(h).name for h in _kernels.HEADERS}
    for name in ("general.cu", "general_accurate.cu"):
        assert '#include "general.cuh"' in (CSRC / name).read_text(), name
    assert '#include "sum_product.cuh"' in (CSRC / "general.cuh").read_text()
    sig = _kernels._SIGNATURES["general"]
    assert sig["ldpc_vec_lanes"] == [_kernels._i, _kernels._i]
    # (..., pre, dtype, lanes, phi, stream)
    assert len(sig["ldpc_cn_general"]) == 14
    assert len(sig["ldpc_vn_general"]) == 15
