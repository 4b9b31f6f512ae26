"""The port's CLI, harness, report, channel factory, smoke and byte counts.

Every case of ``tests/test_cli.py`` runs against
``ldpc_decoder_tpu_torch.cli.main`` on the CPU (``--device cpu`` with
``--memory-bytes``, since the lane model has no card to ask); the port's
Summary is held to the JAX CLI's on the same alist, seed and flags
(float32 sum-product and int8 min-sum, and the BSC from each package's
native library: every line equal but the time and throughput ones), and the report module to its JAX original on the same
inputs (identical strings).
"""

import math
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from ldpc_decoder_tpu import channels as jax_channels  # noqa: E402
from ldpc_decoder_tpu.cli import main as jax_main  # noqa: E402
from ldpc_decoder_tpu.codes.code import LDPCCode as JaxLDPCCode  # noqa: E402
from ldpc_decoder_tpu import native as jax_native  # noqa: E402
from ldpc_decoder_tpu.runtime import datagen as jax_datagen  # noqa: E402
from ldpc_decoder_tpu.runtime import report as jax_report  # noqa: E402

from ldpc_decoder_tpu_torch import channels, native  # noqa: E402
from ldpc_decoder_tpu_torch.cli import main  # noqa: E402
from ldpc_decoder_tpu_torch.codes.code import LDPCCode  # noqa: E402
from ldpc_decoder_tpu_torch.codes.generate import make_regular_code  # noqa: E402
from ldpc_decoder_tpu_torch.codes.qc import (  # noqa: E402
    make_qc_code,
    write_qc_alist,
)
from ldpc_decoder_tpu_torch.ops import qc_grouped as qg  # noqa: E402
from ldpc_decoder_tpu_torch.ops import qc_regular as qr  # noqa: E402
from ldpc_decoder_tpu_torch.ops.phi import phi_abs  # noqa: E402
from ldpc_decoder_tpu_torch.ops.qc_decode import QCDecodeTables  # noqa: E402
from ldpc_decoder_tpu_torch.runtime import datagen, perf, report  # noqa: E402
from ldpc_decoder_tpu_torch.runtime.datagen import create_data  # noqa: E402
from ldpc_decoder_tpu_torch.runtime.decoder import LDPCDecoder  # noqa: E402
from ldpc_decoder_tpu_torch.runtime.params import (  # noqa: E402
    DynamicParams,
    StaticParams,
)
from ldpc_decoder_tpu_torch.runtime.smoke import (  # noqa: E402
    _check_phi,
    cuda_numerics_smoke,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE_36 = np.ones((3, 6), dtype=np.int8)
CPU = ["--device", "cpu", "--memory-bytes", str(1 << 30)]
RUN = ["-p", "3", "-m", "1", "-e", "15", "-i", "40", "-r", "1"]
BER0 = "Bit error rate (BER):             0"


@pytest.fixture(scope="module")
def small_alist(tmp_path_factory):
    path = tmp_path_factory.mktemp("cli") / "qc36.alist"
    code, s = make_qc_code(BASE_36, Z=64, seed=3)
    write_qc_alist(code, s, str(path))
    return str(path)


# tests/test_cli.py's cases: (extra argv, exit code, in stdout, in stderr,
# not in stderr)
CLI_CASES = {
    "conflicting_b_and_e": (["-c", "1", "-n", "0.7", "-e", "5", "-b",
                             "0.01"], 1, ["Cannot define both"], [], []),
    "invalid_loading_factor": (["-c", "1", "-n", "0.7", "-m", "0"], 1,
                               ["Invalid overloading factor"], [], []),
    "zero_runs_exits_cleanly": (["-c", "1", "-n", "0.7", "-r", "0"], 0,
                                ["0 runs to perform"], [], []),
    "bad_channel_index": (["-c", "7", "-n", "0.7"], 1,
                          ["unknown channel type 7"], [], []),
    "end_to_end_awgn": (["-c", "1", "-n", "0.65", *RUN], 0,
                        [BER0, "Decoding throughput"], [], []),
    "end_to_end_erasure_channel": (["-c", "2", "-n", "0.2", *RUN], 0,
                                   [BER0, "Binary erasure channel"], [],
                                   []),
    "first_check_warns_when_burst_eats_retires": (
        ["-c", "1", "-n", "0.65", "-p", "3", "-m", "1", "-e", "15", "-i",
         "60", "-r", "1", "--first-check", "30"], 0, [BER0],
        ["--first-check 0 for an untainted number"], []),
    "first_check_no_warning_when_unused": (
        ["-c", "1", "-n", "0.65", *RUN], 0, [BER0], [], ["--first-check"]),
    "int8_minsum_dtype": (
        ["-c", "1", "-n", "0.6", *RUN, "--dtype", "int8", "--algorithm",
         "min-sum", "--qscale", "8.0", "--minsum-clamp", "12.0",
         "--minsum-offset", "0.5"], 0, [BER0], [], []),
    "int8_requires_minsum": (["-c", "1", "-n", "0.6", "--dtype", "int8"], 1,
                             ["min-sum"], [], []),
    "minsum_alpha_degree_table": (
        ["-c", "1", "-n", "0.6", *RUN, "--algorithm", "min-sum",
         "--minsum-offset", "0.0", "--minsum-alpha", "6:0.8125,0:0.8125"],
        0, [BER0], [], []),
    "minsum_alpha_parse_error": (["-c", "1", "-n", "0.6", "--minsum-alpha",
                                  "6:a"], 1, ["minsum-alpha"], [], []),
    "exact_lane_count": (["-c", "1", "-n", "0.6", *RUN, "--lanes", "48"], 0,
                         ["Number of vectors (or frames) per run: 48"], [],
                         []),
    "kernel_pallas_not_ported": (["-c", "1", "-n", "0.7", "--kernel",
                                  "pallas"], 1, ["not ported"], [], []),
    "log_level_2_phases_and_progress": (
        ["-c", "1", "-n", "0.65", *RUN, "-l", "2"], 0,
        [BER0, "Phase timings (per call):", "bp_iteration",
         "refill_message_init", "frames remaining: 0"], [], []),
}


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_cli_cases(small_alist, capsys, case):
    argv, rc, outs, errs, not_errs = CLI_CASES[case]
    assert main(["-f", small_alist, *argv, *CPU]) == rc
    captured = capsys.readouterr()
    for s in outs:
        assert s in captured.out, s
    for s in errs:
        assert s in captured.err, s
    for s in not_errs:
        assert s not in captured.err, s


def test_missing_code_file(capsys):
    rc = main(["-f", "/nonexistent/code.alist", "-c", "1", "-n", "0.7", *CPU])
    assert rc == 1
    assert "Code file name:/nonexistent/code.alist" in capsys.readouterr().out


def test_general_path_plain_alist(tmp_path, capsys):
    """A non-QC alist goes through the general path."""
    code = make_regular_code(192, 3, 6, seed=5)
    path = tmp_path / "plain.alist"
    code.to_alist(str(path))
    rc = main(["-f", str(path), "-c", "0", "-n", "0.02", *RUN, *CPU])
    assert rc == 0
    assert BER0 in capsys.readouterr().out


def test_device_cuda_without_card_exits_1(small_alist, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(["-f", small_alist, "-c", "1", "-n", "0.7"]) == 1
    out = capsys.readouterr().out
    assert "No CUDA device" in out and "Code file name" not in out


# lines that carry a time or a rate: the only ones allowed to differ
TIMED = ("Elapsed system time", "Throughput including", "Iteration time per",
         "Decoding throughput")


def _summary(text):
    lines = text[text.index("Summary"):].splitlines()
    return [ln for ln in lines if not ln.startswith(TIMED)]


@pytest.mark.parametrize("channel,flags", [
    (["-c", "1", "-n", "0.75"], []),
    (["-c", "1", "-n", "0.75"],
     ["--dtype", "int8", "--algorithm", "min-sum", "--minsum-offset", "0.0",
      "--minsum-alpha", "6:0.8125,0:0.8125"]),
    (["-c", "0", "-n", "0.06"], []),
], ids=["float32-sum-product", "int8-min-sum", "bsc-native"])
def test_summary_matches_jax_cli(small_alist, capsys, monkeypatch, channel,
                                 flags):
    """Same alist, seed and flags through both CLIs (two runs from frame
    5 at σ = 0.75 or p = 0.06): the Summary lines are
    equal but the time and throughput ones. The BSC frames come from each
    package's native library on both sides (the harness's default
    backend)."""
    bsc = channel[1] == "0"
    if bsc:
        if not (native.available() and jax_native.available()):
            pytest.skip("g++ cannot build the native libraries")
        taken = []
        for module in (datagen, jax_datagen):
            real = module._create_data_native
            monkeypatch.setattr(
                module, "_create_data_native",
                lambda *a, real=real, m=module: taken.append(m) or real(*a))
    argv = ["-f", small_alist, *channel, "-p", "3", "-m", "1", "-e", "3",
            "-i", "30", "-r", "2", "-s", "5", "--check-period", "5",
            "--memory-bytes", str(1 << 30), *flags]
    assert jax_main(argv) == 0
    ref = capsys.readouterr().out
    assert main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert _summary(got) == _summary(ref)
    assert len(_summary(got)) > 20
    if bsc:  # two batches each
        assert taken == [jax_datagen] * 2 + [datagen] * 2


def test_report_matches_jax(small_alist):
    """describe_* and TestReport.gen_summary give the JAX module's strings
    on the same inputs."""
    code = LDPCCode.from_alist(small_alist)
    jcode = JaxLDPCCode.from_alist(small_alist)
    for idx, noise in ((0, 0.02), (1, 0.8), (2, 0.3)):
        ch = channels.make_channel(idx, noise)
        jch = jax_channels.make_channel(idx, noise)
        assert (report.describe_code_and_channel(code, ch)
                == jax_report.describe_code_and_channel(jcode, jch))
    errors = np.array([0, 3, 17, 0, 1])
    for n, log_level in ((5, 1), (5, 3), (1, 1)):
        assert (report.describe_error_stats(n, 40, errors[:n], 384,
                                            log_level)
                == jax_report.describe_error_stats(n, 40, errors[:n], 384,
                                                   log_level))
    fields = dict(code_and_channel_specs="specs\n", num_vectors_per_run=64,
                  num_runs=3, frame_size=1 << 20, target_errors=15,
                  avg_iter=41.5, iter_time_per_vector=3.25e-5,
                  min_iter=30, max_iter=120, elapsed_time=2.5,
                  vectors_with_errors=2, max_bit_error=40,
                  num_bit_errors=77, vectors_with_error_above_target=1)
    for kw in (fields, dict(fields, target_errors=0, elapsed_time=0.0)):
        assert (report.TestReport(**kw).gen_summary()
                == jax_report.TestReport(**kw).gen_summary())


def test_make_channel():
    for idx, noise, cls in ((0, 0.01, channels.BSCChannel),
                            (1, 0.9, channels.BIAWGNChannel),
                            (2, 0.4, channels.ErasureChannel)):
        ch = channels.make_channel(idx, noise)
        assert isinstance(ch, cls)
        assert (ch.description()
                == jax_channels.make_channel(idx, noise).description())
    with pytest.raises(ValueError, match="unknown channel type"):
        channels.make_channel(3, 0.5)


@pytest.fixture(scope="module")
def small_decoder():
    code, s = make_qc_code(BASE_36, Z=64, seed=3)
    ch = channels.BIAWGNChannel(0.7)
    dec = LDPCDecoder(code, ch, StaticParams(parallel_factor_user=8), qc=s,
                      device="cpu")
    return dec, create_data(code, ch, 0, 24, backend="numpy")


def test_profile_phases_keys(small_decoder):
    """The JAX decoder's keys, finite non-negative seconds."""
    dec, batch = small_decoder
    pools = dec.upload_pools(batch.values, batch.syndromes)
    out = dec.profile_phases(*pools, DynamicParams(num_iter_check_parity=5),
                             24, repeats=2)
    assert list(out) == ["bp_iteration", "parity_and_bits",
                         "superstep_total", "retire_refill_pack",
                         "refill_message_init"]
    assert all(math.isfinite(v) and v >= 0 for v in out.values())


def test_decode_progress(small_decoder):
    """``progress`` sees the frames left after every superstep, down to 0;
    the words are those of a decode without it."""
    dec, batch = small_decoder
    dyn = DynamicParams(num_iter_check_parity=5)
    seen = []
    res, st = dec.decode(dyn, 24, batch.values, batch.syndromes,
                         host_poll=True, progress=seen.append)
    assert len(seen) == st.total_supersteps and seen[-1] == 0
    assert all(a >= b for a, b in zip(seen, seen[1:]))
    res2, _ = dec.decode(dyn, 24, batch.values, batch.syndromes)
    np.testing.assert_array_equal(res, res2)


@pytest.mark.parametrize("family,dtype", [
    ("grouped", torch.float32), ("regular", torch.float32),
    ("regular", torch.float8_e5m2)])
def test_smoke_phi_probe_on_cpu(family, dtype):
    """The smoke's φ probe (one check pass on a degree-2 check) computes
    signed φ on the plain passes too; the smoke itself needs a card."""
    x = np.array([0.5, -2.0, 10.0, -30.0], np.float32)
    got = _check_phi(x, dtype, family, torch.device("cpu")).float()
    high = 10.0 if dtype == torch.float8_e5m2 else 80.0
    xq = torch.from_numpy(x).to(dtype).float()  # the messages' own values
    want = torch.copysign(phi_abs(xq.abs(), high=high), xq).to(dtype).float()
    assert torch.equal(got, want)
    with pytest.raises(RuntimeError, match="CUDA"):
        cuda_numerics_smoke("cpu")


def test_perf_bytes(small_decoder):
    """Unique bytes per pass: a regular base counted as the grouped family
    differs only in its slot tables (8 bytes per block against 12)."""
    dec, _ = small_decoder
    t = dec.tables
    assert isinstance(t, qr.QCRegularTables)
    tg = qg.GroupedQCTables.from_qc_tables(QCDecodeTables.from_structure(
        dec.qc, 0, "cpu"))
    B, nb = 256, t.n_edges // t.Z
    for mb, lb in ((2, 2), (1, 2), (4, 4)):
        r = perf.regular_bytes(t, B, mb, lb)
        g = perf.grouped_bytes(tg, B, mb, lb)
        assert r["cn"] == 2 * t.n_edges * B * mb + t.n_checks * B + 12 * nb
        assert {k: r[k] - g[k] for k in r} == {
            "cn": 4 * nb, "vn": 4 * nb, "parity": 4 * nb}


def test_module_runs_as_script(small_alist):
    """``python -m ldpc_decoder_tpu_torch.cli`` on the CPU."""
    r = subprocess.run(
        [sys.executable, "-m", "ldpc_decoder_tpu_torch.cli", "-f",
         small_alist, "-c", "1", "-n", "0.65", *RUN, *CPU], cwd=REPO,
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert BER0 in r.stdout
