"""The port's code-design search on the CPU at small sizes: each
``scripts/<name>_torch.py`` against ``scripts/<name>.py`` on the same seed,
arguments and environment, and ``channels/biawgn.py`` ``shannon_sigma``
against the JAX package's.

Every score, threshold, DE iteration count, ``rng`` draw, base, lift and
alist is held exactly (the port's ``codes/pexit.py`` and
``codes/protographs.py`` are numpy copies), and so are the printed lines
with the wall times masked. Each script reads its knobs from the
environment when it is imported, so every run imports both scripts afresh
with the environment set first. ``design_code_torch.py --measure --device
cpu`` is held to a decode by ``bench.py``'s ``run_point`` protocol on the
JAX decoder, its QC passes through the XLA ops that its Pallas kernels are
held to (the Pallas kernels in interpret mode take minutes), in FER(>0),
FER(>15), BER, average iterations, frames and lanes (bfloat16 sum-product
where every frame decodes, where the two agree exactly).
"""

import importlib
import os
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")
TWINS = ("optimize_proto", "optimize_fast", "optimize_work",
         "optimize_edge", "optimize_base", "optimize_minsum", "design_code")
KNOBS = ("DE_ITERS", "ROW_DEG", "SIGMA_OP", "EDGE", "OBJ", "DELTA",
         "SIGMA_MIN", "ALPHA", "BETA", "EDGE_SIGMA", "N_SAMPLES", "MAX_DE",
         "SEED_BASE", "BENCH_LOGP")


def _purge():
    for name in list(sys.modules):
        if name.startswith(TWINS):
            del sys.modules[name]


@pytest.fixture
def load(monkeypatch):
    """load(name, **env) -> (the JAX script, its twin), each imported afresh
    with ``env`` over an environment without the scripts' knobs."""
    monkeypatch.syspath_prepend(SCRIPTS)
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)

    def _load(name, **env):
        for k, v in env.items():
            monkeypatch.setenv(k, str(v))
        mods = []
        for mod in (name, f"{name}_torch"):
            _purge()
            mods.append(importlib.import_module(mod))
        return tuple(mods)

    yield _load
    _purge()


def _masked(text):
    """Printed lines with the wall times masked."""
    return re.sub(r"\(\d+s\)|\[\d+s\]| in \d+s ", "(Ts)", text)


def _main_outputs(capsys, monkeypatch, jax_mod, twin, argv):
    """(JAX script's stdout, twin's stdout) of ``main`` on ``argv``."""
    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", [jax_mod.__file__] + list(argv))
    jax_mod.main()
    want = capsys.readouterr().out
    twin.main(argv)
    got = capsys.readouterr().out
    return _masked(want), _masked(got)


# ---- the imports ----

def _imports(path):
    with open(path) as f:
        src = f.read()
    return re.findall(r"^\s*(?:from|import)\s+([\w.]+)", src, re.M)


@pytest.mark.parametrize("path", [f"scripts/{n}_torch.py" for n in TWINS]
                         + ["ldpc_decoder_tpu_torch/channels/biawgn.py"])
def test_twins_import_no_jax(path):
    mods = _imports(os.path.join(REPO, path))
    assert mods, path
    for mod in mods:
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "ldpc_decoder_tpu"), (path, mod)
        assert top not in TWINS, (path, mod)  # siblings by their twins


def test_twins_run_from_another_directory(tmp_path):
    """From a directory outside the repo: every twin imports, and
    ``design_code_torch.py`` builds a small code (no --measure), with no
    JAX module loaded."""
    code = (
        "import importlib, runpy, sys\n"
        f"sys.path.insert(0, {SCRIPTS!r})\n"
        f"for n in {[t + '_torch' for t in TWINS[:-1]]!r}:\n"
        "    importlib.import_module(n)\n"
        f"sys.argv = ['design_code_torch.py', '--rate', '0.5', '--n', "
        f"'4096', '--coarse', '64', '--fine-mod', '8', '--out', "
        f"{str(tmp_path / 'd.alist')!r}]\n"
        "try:\n"
        f"    runpy.run_path({os.path.join(SCRIPTS, 'design_code_torch.py')!r},"
        " run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert not e.code, e.code\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'ldpc_decoder_tpu')]\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k not in KNOBS}
    env["PYTHONPATH"] = ""
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "construction only" in r.stdout
    assert (tmp_path / "d.alist").exists()


# ---- shannon_sigma ----

@pytest.mark.parametrize("rate,tol", [(0.1, 1e-4), (0.5, 1e-4), (0.8, 1e-4),
                                      (0.9, 1e-4), (0.5, 1e-6), (0.75, 1e-2)])
def test_shannon_sigma_matches_jax(rate, tol):
    from ldpc_decoder_tpu.channels.biawgn import shannon_sigma as jax_sigma

    from ldpc_decoder_tpu_torch.channels.biawgn import shannon_sigma

    assert shannon_sigma(rate, tol) == jax_sigma(rate, tol)


@pytest.mark.parametrize("rate", [0.0, 1.0, -0.5, 1.5])
def test_shannon_sigma_refuses_a_rate_outside_0_1(rate):
    from ldpc_decoder_tpu_torch.channels.biawgn import shannon_sigma

    with pytest.raises(ValueError, match="rate must be in"):
        shannon_sigma(rate)


# ---- optimize_proto ----

@pytest.mark.parametrize("R,n_punct,row_deg", [(4, 1, 0), (3, 1, 0),
                                               (4, 1, 6), (5, 2, 0)])
def test_proto_draws_and_scores(load, R, n_punct, row_deg):
    """seed_bases (BEST_KNOWN, AR4JA at 3x5/1p, the random sampler,
    ROW_DEG), neighbor draws, valid, score and profile: equal bases and
    scores from equal generators."""
    jp, tp = load("optimize_proto", ROW_DEG=row_deg, DE_ITERS=40)
    assert (tp.DE_ITERS, tp.ROW_DEG) == (jp.DE_ITERS, jp.ROW_DEG) == (
        40, row_deg)
    assert (tp.MAX_COL, tp.MAX_ROW, tp.MAX_ENTRY) == (
        jp.MAX_COL, jp.MAX_ROW, jp.MAX_ENTRY)
    assert tp.BEST_KNOWN.keys() == jp.BEST_KNOWN.keys()
    for k, b in jp.BEST_KNOWN.items():
        np.testing.assert_array_equal(tp.BEST_KNOWN[k], b)
    C = 2 * R - n_punct
    rj, rt = np.random.default_rng(7), np.random.default_rng(7)
    bj, bt = jp.seed_bases(R, C, n_punct, rj), tp.seed_bases(R, C, n_punct,
                                                              rt)
    assert len(bj) == len(bt)
    for a, b in zip(bj, bt):
        np.testing.assert_array_equal(a, b)
        assert tp.valid(b, n_punct) and jp.valid(a, n_punct)
    cur_j, cur_t = bj[0], bt[0]
    for _ in range(6):
        cur_j, cur_t = (jp.neighbor(cur_j, n_punct, rj),
                        tp.neighbor(cur_t, n_punct, rt))
        np.testing.assert_array_equal(cur_j, cur_t)
    assert rj.random() == rt.random()
    assert tp.score(cur_t, n_punct) == jp.score(cur_j, n_punct)
    assert tp.score(cur_t, n_punct, lo=0.8) == jp.score(cur_j, n_punct,
                                                        lo=0.8)
    np.testing.assert_array_equal(
        tp.random_base(R, C, n_punct, np.random.default_rng(3)),
        jp.random_base(R, C, n_punct, np.random.default_rng(3)))
    if (R, n_punct, row_deg) == (4, 1, 0):
        assert tp.profile(bt[0], n_punct) == jp.profile(bj[0], n_punct)


def test_proto_anneal_matches(load, capsys, monkeypatch):
    """15 annealing steps at 3x5/1p from AR4JA and the random seeds (an
    improvement at step 2): the same lines, the same final base and
    profile."""
    jp, tp = load("optimize_proto", DE_ITERS=40)
    want, got = _main_outputs(capsys, monkeypatch, jp, tp,
                              ["3", "1", "15", "1"])
    assert got == want
    assert " * BASE=" in got and "BASE = np.array(" in got


# ---- optimize_fast, optimize_work, optimize_edge ----

def test_fast_iters_to_converge_and_score(load):
    jf, tf = load("optimize_fast", SIGMA_OP=0.93, EDGE=0.945, OBJ="work")
    assert (tf.SIGMA_OP, tf.EDGE, tf.OBJ, tf.MAX_DE) == (
        jf.SIGMA_OP, jf.EDGE, jf.OBJ, jf.MAX_DE) == (0.93, 0.945, "work",
                                                     200)
    rng = np.random.default_rng(5)
    bases = [jf.BEST_KNOWN[k] for k in sorted(jf.BEST_KNOWN)]
    bases += [jf.random_base(4, 7, 1, rng) for _ in range(3)]
    for b in bases:
        p = 2 * b.shape[0] - b.shape[1]  # rate 1/2: C = 2R - p
        for sigma in (0.8, 0.93, 0.96):
            assert (tf.iters_to_converge(b, p, sigma)
                    == jf.iters_to_converge(b, p, sigma))
        assert tf.iters_to_converge(b, p, 0.9, target=1 - 1e-3) == (
            jf.iters_to_converge(b, p, 0.9, target=1 - 1e-3))
        assert tf.score(b, p) == jf.score(b, p)


@pytest.mark.parametrize("name,argv,env", [
    ("optimize_fast", ["4", "1", "15", "3"], {}),
    ("optimize_fast", ["3", "1", "15", "3"],
     {"OBJ": "work", "SIGMA_OP": 0.9, "EDGE": 0.91}),
    ("optimize_work", ["4", "1", "15", "4"], {}),
    ("optimize_edge", ["4", "1", "10", "5"], {})])
def test_anneal_matches(load, capsys, monkeypatch, name, argv, env):
    """10-15 annealing steps of each: the same lines (seed, every
    improvement, the progress lines, FINAL/BEST, degrees, BASE, the p41
    baselines)."""
    jm, tm = load(name, **env)
    for k in ("SIGMA_OP", "EDGE", "OBJ", "DELTA", "SIGMA_MIN", "MAX_DE"):
        if hasattr(jm, k):
            assert getattr(tm, k) == getattr(jm, k), k
    want, got = _main_outputs(capsys, monkeypatch, jm, tm, argv)
    assert got == want
    assert "base" in got.lower()


def test_work_and_edge_scores(load):
    bases = None
    for name, env in (("optimize_work", {"SIGMA_OP": 0.94, "EDGE": 0.95}),
                      ("optimize_edge", {"DELTA": 0.003})):
        jm, tm = load(name, **env)
        if bases is None:
            rng = np.random.default_rng(11)
            bases = [jm.seed_bases(4, 7, 1, rng)[0]]
            bases += [jm.neighbor(bases[0], 1, rng) for _ in range(4)]
        for b in bases:
            assert tm.score(b, 1) == jm.score(b, 1), name


# ---- optimize_base ----

def test_base_swap_moves(load):
    from ldpc_decoder_tpu_torch.codes.protographs import ru_irregular_base

    jb, tb = load("optimize_base")
    assert tb.DE_ITERS == jb.DE_ITERS == 60
    base, _ = ru_irregular_base(3, seed=1)
    rj, rt = np.random.default_rng(2), np.random.default_rng(2)
    for _ in range(20):
        a, b = jb.swap_move(base, rj), tb.swap_move(base, rt)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(b.sum(axis=0), base.sum(axis=0))
        np.testing.assert_array_equal(b.sum(axis=1), base.sum(axis=1))
        base = b


def test_base_hill_climb_matches(load, capsys, monkeypatch):
    """The 24 RU seeds at scale 3 and a hill-climb cut at 15 moves (each
    script's own swap_move, stopped by None as when no move is left), at
    DE_ITERS = 20."""
    jb, tb = load("optimize_base")
    for mod in (jb, tb):
        monkeypatch.setattr(mod, "DE_ITERS", 20)
        moves, left = mod.swap_move, [15]

        def capped(base, rng, moves=moves, left=left):
            left[0] -= 1
            return moves(base, rng) if left[0] >= 0 else None
        monkeypatch.setattr(mod, "swap_move", capped)
    want, got = _main_outputs(capsys, monkeypatch, jb, tb, ["3"])
    assert got == want
    assert "climb -> " in got and "FINAL threshold" in got


# ---- optimize_minsum ----

MINSUM_ENV = {"N_SAMPLES": 500, "MAX_DE": 40, "SIGMA_OP": 0.85,
              "EDGE_SIGMA": 0.86}


@pytest.mark.parametrize("alpha", ["0.95", "0.8", "3:0.9,6:0.85,0:1.0"])
def test_minsum_knobs_and_scores(load, alpha):
    jm, tm = load("optimize_minsum", ALPHA=alpha, BETA=0.3, **MINSUM_ENV)
    for k in ("ALPHA", "BETA", "SIGMA_OP", "EDGE_SIGMA", "N_SAMPLES",
              "MAX_DE", "DE_SEEDS"):
        assert getattr(tm, k) == getattr(jm, k), k
    assert tm.parse_alpha(alpha) == jm.parse_alpha(alpha)
    from ldpc_decoder_tpu_torch.codes.protographs import P41_BASE

    b = P41_BASE.astype(np.int64)
    for sigma in (0.8, 0.85):
        assert (tm.de_iters(b, 1, sigma, 7, 40)
                == jm.de_iters(b, 1, sigma, 7, 40))
    assert tm.score(b, 1) == jm.score(b, 1)
    assert tm.edge_ok(b, 1) == jm.edge_ok(b, 1)


def test_minsum_anneal_matches(load, capsys, monkeypatch):
    """Three annealing steps at N_SAMPLES = 500, MAX_DE = 40 from
    SEED_BASE and the seeds. The final re-check asks each script's
    minsum_de_run for 30,000 samples; it is recorded and run at 1,000
    (30,000 take 20 s a script)."""
    jm, tm = load("optimize_minsum", SEED_BASE="[[0,1,1,0,1,0,3],"
                  "[0,1,0,1,2,1,2],[0,2,0,1,1,1,1],[1,0,0,0,0,0,2]]",
                  **MINSUM_ENV)
    calls = {}
    for key, mod in (("jax", jm), ("port", tm)):
        run, seen = mod.minsum_de_run, calls.setdefault(key, [])

        def recorded(*a, run=run, seen=seen, **k):
            if k["n_samples"] > 1000:
                seen.append((a[1], k))
                k = {**k, "n_samples": 1000}
            return run(*a, **k)
        monkeypatch.setattr(mod, "minsum_de_run", recorded)
    want, got = _main_outputs(capsys, monkeypatch, jm, tm,
                              ["4", "1", "3", "1"])
    assert got == want
    assert "recheck(30k" in got and "BASE = np.array(" in got
    assert calls["port"] == calls["jax"]
    assert [k["n_samples"] for _, k in calls["port"]] == [30000] * 4


# ---- design_code ----

@pytest.mark.parametrize("rate,punct,shape", [
    (0.5, 1, None), (0.5, 2, None), (0.5, 0, None), (0.8, 0, None),
    (0.75, 1, None), (0.5, 1, "6x11"), (0.97, 0, None)])
def test_design_pick_shape(load, rate, punct, shape):
    jd, td = load("design_code")
    try:
        want = jd.pick_shape(rate, punct, shape)
    except SystemExit as e:
        with pytest.raises(SystemExit, match=re.escape(str(e))):
            td.pick_shape(rate, punct, shape)
        return
    assert td.pick_shape(rate, punct, shape) == want


@pytest.mark.parametrize("shape,steps,sigma_op,edge", [
    ((4, 7, 1), 0, 0.939, 0.949),    # the recorded optimum
    ((3, 5, 1), 0, 0.9, 0.91),       # no record: the seeds alone
    ((3, 5, 1), 12, 0.9, 0.91)])
def test_design_anneal_base(load, capsys, shape, steps, sigma_op, edge):
    jd, td = load("design_code")
    R, C, p = shape
    capsys.readouterr()
    want = jd.anneal_base(R, C, p, steps, sigma_op, edge, 4)
    out_j = capsys.readouterr().out
    got = td.anneal_base(R, C, p, steps, sigma_op, edge, 4)
    out_t = capsys.readouterr().out
    np.testing.assert_array_equal(got, want)
    assert _masked(out_t) == _masked(out_j)


def _design_argv(n=4096, extra=()):
    return ["--rate", "0.5", "--n", str(n), "--coarse", "64",
            "--fine-mod", "8", *extra]


def test_design_lift_and_cache(load, capsys, monkeypatch, tmp_path):
    """main without --measure at n = 4096 (Z = 192, m = 3, two seeds): the
    same lines but the paths and the closing hint, the same summary, the
    same alist files with the same #params header; run again, the twin
    reads its cache."""
    from ldpc_decoder_tpu_torch.codes.qc import read_alist_params

    jd, td = load("design_code")
    monkeypatch.setattr(jd, "CACHE", str(tmp_path / "jax"))
    monkeypatch.setattr(td, "CACHE", str(tmp_path / "port"))
    argv = _design_argv(extra=["--seeds", "3,5"])
    want, got = _main_outputs(capsys, monkeypatch, jd, td, argv)
    strip = (lambda s: s.replace(str(tmp_path / "jax"), "CACHE")
             .replace(str(tmp_path / "port"), "CACHE").splitlines())
    w, g = strip(want), strip(got)
    assert g[:-2] == w[:-2]
    assert g[-2].startswith("(construction only") and g[-1] == w[-1]
    assert "Z=192, m=3" in got
    for sd in (3, 5):
        name = f"designed_r0.5_t0.949_4x7p1_s{sd}.alist"
        a = (tmp_path / "jax" / name).read_bytes()
        b = (tmp_path / "port" / name).read_bytes()
        assert a == b
        assert read_alist_params(str(tmp_path / "port" / name)) == {
            "base": "[[0, 1, 1, 0, 1, 0, 3], [0, 1, 0, 1, 2, 1, 2], "
                    "[0, 2, 0, 1, 1, 1, 1], [1, 0, 0, 0, 0, 0, 2]]",
            "punct": "1", "m": "3", "Z": "192", "seed": str(sd),
            "coarse": "64", "fine_mod": "8"}
    assert td.main(argv) == 0
    again = capsys.readouterr().out
    assert again.count(": cached ") == 2 and "lifted" not in again


def _jax_run_point(path, sigma, frames):
    """bench.py's run_point on the JAX decoder (its QC passes on the XLA
    ops): FER(>0), FER(>15), BER, average iterations, frames and lanes."""
    from ldpc_decoder_tpu.channels import BIAWGNChannel
    from ldpc_decoder_tpu.codes.qc import load_qc_alist
    from ldpc_decoder_tpu.runtime.datagen_device import (
        count_bit_errors,
        create_pool_device,
    )
    from ldpc_decoder_tpu.runtime.decoder import LDPCDecoder
    from ldpc_decoder_tpu.runtime.params import DynamicParams, StaticParams

    code, s = load_qc_alist(path)
    ch = BIAWGNChannel(sigma)
    dec = LDPCDecoder(code, ch, StaticParams(
        max_log_parallel_factor_user=8, message_dtype="bfloat16",
        algorithm="sum-product", kernel_impl="xla"), qc=s)
    B = dec.parallel_factor()
    lf = max(2, -(-frames // B))
    dyn = DynamicParams(num_iter_max=120, num_iter_check_parity=14,
                        num_iter_first_check=0, loading_factor=lf,
                        target_errors=15)
    n = (min(frames, B * lf) // 32) * 32
    pool = create_pool_device(dec.cc, dec.tables, ch, 0, n)
    res, st = dec.decode_presorted(dyn, n, pool.values_sorted,
                                   pool.syn_sorted, fetch_results=False)
    errors = np.asarray(count_bit_errors(res, pool.ref_packed))
    return {"fer1": float((errors > 0).mean()),
            "fer15": float((errors > 15).mean()),
            "ber": float(errors.sum()) / (code.n_vars * n),
            "avg_iters": round(st.avg_iter, 2), "n": n, "B": B}, st


def test_design_measure_on_cpu_matches_the_jax_protocol(load, capsys,
                                                        monkeypatch,
                                                        tmp_path):
    """``--measure --device cpu`` at n = 4096, 64 frames, target threshold
    0.8 (operating point 0.79, the waterfall at 0.79 too): both points
    equal the JAX run_point protocol's decode of the same alist, with the
    JAX decoder's per-frame iterations, and the two the same words."""
    import json

    _, td = load("design_code")
    monkeypatch.setattr(td, "CACHE", str(tmp_path))
    points = []
    measure = td.measure_point

    def recorded(code, qc, sigma, frames, device, check_period=14):
        rec = measure(code, qc, sigma, frames, device, check_period)
        points.append((sigma, rec))
        return rec
    monkeypatch.setattr(td, "measure_point", recorded)
    capsys.readouterr()
    assert td.main(_design_argv(extra=[
        "--threshold", "0.8", "--sigmas", "0.79", "--frames", "64",
        "--measure", "--device", "cpu"])) == 0
    out = capsys.readouterr().out
    summary = json.loads(out.strip().splitlines()[-1])
    assert [sg for sg, _ in points] == [0.79, 0.79]
    assert summary["card"] == {"name": "cpu", "power_limit": None}
    assert [p["sigma"] for p in summary["waterfall"]] == [0.79]
    want, st = _jax_run_point(summary["final_alist"], 0.79, 64)
    assert want["n"] == 64 and want["B"] == 256
    for sigma, rec in points:
        assert {k: rec[k] for k in want} == want
        assert rec["tables"] == "GroupedQCTables"
        np.testing.assert_array_equal(rec["iterations"], st.iterations)
        assert rec["max_iters"] == st.max_iter
        assert rec["min_iters"] == st.min_iter
        assert rec["mbps"] > 0 and rec["itpv"] > 0
        assert rec["fer1"] == float((rec["errors"] > 0).mean())
    torch.testing.assert_close(points[0][1]["results"],
                               points[1][1]["results"], rtol=0, atol=0)
    assert summary["mbps_at_op"] == round(points[0][1]["mbps"], 1)
    for pt, (sigma, rec) in zip(summary["waterfall"], points[1:]):
        assert pt == {"sigma": sigma, "fer1": rec["fer1"],
                      "fer15": rec["fer15"], "ber": rec["ber"],
                      "avg_iters": rec["avg_iters"], "frames": rec["n"]}
    assert f"seed 3: {points[0][1]['mbps']:.1f} Mb/s" in out


def test_design_measure_refuses_cuda_without_a_card(load, capsys,
                                                    monkeypatch, tmp_path):
    _, td = load("design_code")
    monkeypatch.setattr(td, "CACHE", str(tmp_path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert td.main(_design_argv(extra=["--measure"])) == 1
    assert "no CUDA device" in capsys.readouterr().err
    assert not list(tmp_path.iterdir())  # it stopped before the lift
