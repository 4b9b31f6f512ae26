"""The port's code-design and measurement scripts on the CPU at small sizes:
``scripts/eval_proto_torch.py`` (its lift and P-EXIT threshold against the
JAX package's), ``scripts/bench_general_torch.py`` (its timed decode against
the JAX decoder on the same frames) and ``scripts/bench_interleaved_torch.py``
(the interleaved renumbering decodes the aligned code's frames to the same
words and iterations). Each runs with ``--device cpu``; without a card,
``--device cuda`` exits 1.

Tolerances: the lift, the threshold, words and per-frame iterations are
exact (bfloat16 sum-product at a point where every frame decodes, where the
port's plain passes and the JAX Pallas kernels in interpret mode agree).
"""

import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


EVAL = _load("eval_proto_torch")
BENCH_GENERAL = _load("bench_general_torch")
BENCH_INTERLEAVED = _load("bench_interleaved_torch")


@pytest.mark.parametrize("mod,argv", [
    (EVAL, ["p41"]), (BENCH_GENERAL, []), (BENCH_INTERLEAVED, [])])
def test_scripts_refuse_cuda_without_a_card(monkeypatch, capsys, mod, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert mod.main(argv + ["--device", "cuda"]) == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_eval_proto_registry_matches_jax():
    """The same candidates as scripts/eval_proto.py, read from its source
    (importing it is harmless, running it needs a TPU)."""
    jax_eval = _load("eval_proto")
    assert sorted(EVAL.PROTOS) == sorted(jax_eval.PROTOS)
    for name, (base, *rest) in jax_eval.PROTOS.items():
        ours = EVAL.PROTOS[name]
        np.testing.assert_array_equal(ours[0], base)
        assert tuple(ours[1:]) == tuple(rest), name


def test_eval_proto_p41_lift_and_threshold(monkeypatch, tmp_path, capsys):
    """``eval_proto_torch.py p41 512 32 0.8 --device cpu``: the P-EXIT
    threshold equals JAX's pexit_threshold, the cached lift equals JAX's
    make_protograph_code_two_stage (seed 1, the candidate's m, coarse and
    fine_mod), and the scan decodes on the grouped family; run again, it
    reads the cache."""
    from ldpc_decoder_tpu.codes.pexit import pexit_threshold
    from ldpc_decoder_tpu.codes.protographs import (
        make_protograph_code_two_stage,
    )

    from ldpc_decoder_tpu_torch.codes.qc import load_qc_alist

    monkeypatch.setattr(EVAL, "CACHE_DIR", str(tmp_path))
    for k in ("EVAL_ALG", "EVAL_DTYPE", "EVAL_BETA", "EVAL_MAX_ITER"):
        monkeypatch.delenv(k, raising=False)
    got = []
    threshold = EVAL.threshold
    monkeypatch.setattr(EVAL, "threshold",
                        lambda name: got.append(threshold(name)) or got[-1])
    assert EVAL.main(["p41", "512", "32", "0.8", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    base, n_punct, m, coarse, fine_mod = EVAL.PROTOS["p41"]
    punct = (base.shape[1] - 1,)
    want = pexit_threshold(base, punct, lo=0.7, hi=1.0, tol=1e-3,
                           max_iters=80)
    assert got == [want]
    assert f"P-EXIT sigma*(80it)={want:.4f}" in out
    assert "two-stage lift" in out
    assert "sigma=0.800: FER(>0)=0.0000 FER(>15)=0.0000 BER=0.00e+00" in out
    assert "B=256 n=32" in out

    code, s = load_qc_alist(str(tmp_path / "proto_p41_Z512.alist"))
    jcode, js = make_protograph_code_two_stage(
        base, punct, m=m, Z=512, seed=1, coarse=coarse, fine_mod=fine_mod)
    for f in ("edge_row", "edge_col", "edge_shift"):
        np.testing.assert_array_equal(getattr(s, f), getattr(js, f))
    assert (code.n_vars, code.n_erased_vars) == (jcode.n_vars,
                                                 jcode.n_erased_vars)
    np.testing.assert_array_equal(code.to_alist_data().check_adjacency,
                                  jcode.to_alist_data().check_adjacency)
    logged = []
    _, s2 = EVAL.lift("p41", 512, log=logged.append)
    assert logged == [f"loaded {tmp_path / 'proto_p41_Z512.alist'}"]
    np.testing.assert_array_equal(s2.edge_shift, js.edge_shift)


def test_bench_general_refuses_a_log2_lane_cap():
    with pytest.raises(SystemExit, match="stale log2"):
        BENCH_GENERAL.main(["8", "--device", "cpu"])


def test_bench_general_matches_the_jax_decoder():
    """The protocol at n = 2048, B = 128, sigma 0.75 (every frame decodes):
    the timed decode's words and per-frame iterations equal the JAX
    decoder's (bench_general.py's decoder: bfloat16, qc_autodetect off,
    the general Pallas kernels) on the same frames and LLRs."""
    import jax.numpy as jnp

    from ldpc_decoder_tpu.channels import BIAWGNChannel
    from ldpc_decoder_tpu.codes.generate import make_regular_code
    from ldpc_decoder_tpu.runtime.datagen import create_data
    from ldpc_decoder_tpu.runtime.decoder import LDPCDecoder
    from ldpc_decoder_tpu.runtime.params import DynamicParams, StaticParams

    rec = BENCH_GENERAL.run(128, 0.75, 2048, "cpu", log=lambda m: None)
    assert rec["B"] == rec["n"] == 128 and rec["fer1"] == 0.0
    code = make_regular_code(2048, 3, 6, seed=9)
    ch = BIAWGNChannel(0.75)
    dec = LDPCDecoder(code, ch, StaticParams(
        parallel_factor_user=128, message_dtype="bfloat16",
        qc_autodetect=False, kernel_impl="pallas"))
    batch = create_data(code, ch, 0, 128)
    pv = jnp.asarray(ch.llr_np(batch.values)[np.asarray(dec.cc.vn_order)]
                     .astype(np.float32))
    ps = jnp.asarray(batch.syndromes[np.asarray(dec.cc.cn_order)]
                     .astype(np.int8))
    res, st = dec.decode_presorted(
        DynamicParams(num_iter_max=120, num_iter_check_parity=10,
                      loading_factor=1, target_errors=15), 128, pv, ps,
        input_is_llr=True)
    np.testing.assert_array_equal(rec["results"], np.asarray(res))
    np.testing.assert_array_equal(rec["iterations"], st.iterations)


def test_bench_interleaved_same_frames():
    """A reg36-shaped code (regular_base(16, 32, 3, 6, seed=2)) at Z = 128:
    the interleaved renumbering is detected (the regular family), decodes
    its pool, and decodes the aligned frames, renumbered, to the aligned
    words and per-frame iterations."""
    from ldpc_decoder_tpu_torch.codes.protographs import regular_base
    from ldpc_decoder_tpu_torch.codes.qc import make_qc_code

    code, s = make_qc_code(regular_base(16, 32, 3, 6, seed=2), Z=128,
                           seed=1, coarse=32, fine_mod=8)
    rec = BENCH_INTERLEAVED.run(code, s, 0.75, 96, "cpu", log=lambda m: None)
    assert rec["tables"] == "QCRegularTables"
    same = rec["same_frames"]
    assert same["frames"] == 96 and same["fer1"] == 0.0
    assert same["aligned"]["tables"] == same["interleaved"]["tables"]
    for run in ("aligned", "interleaved"):
        assert rec[run]["fer1"] == 0.0 and rec[run]["n"] == 96
    assert rec["ratio"] > 0


def test_bench_interleaved_catches_a_wrong_renumbering():
    """same_frames fails when the frames are not the renumbered batch (a
    small code: phase 22's base at Z = 64)."""
    from ldpc_decoder_tpu_torch.codes.protographs import regular_base
    from ldpc_decoder_tpu_torch.codes.qc import (
        interleave_code_numbering,
        make_qc_code,
    )
    from ldpc_decoder_tpu_torch.runtime.datagen import create_data

    code, s = make_qc_code(regular_base(4, 8, 3, 6, seed=5), Z=64, seed=2,
                           min_girth=0)
    icode, to_v, to_c = interleave_code_numbering(code, s.Z)
    dec_a = BENCH_INTERLEAVED.make_decoder(code, s, 0.75, "cpu")
    dec_i = BENCH_INTERLEAVED.make_decoder(icode, None, 0.75, "cpu")
    batch = create_data(code, dec_a.channel, 0, 32, backend="numpy")
    with pytest.raises(AssertionError, match="differ"):
        BENCH_INTERLEAVED.same_frames(dec_a, dec_i, to_v[::-1].copy(), to_c,
                                      batch, 32)
