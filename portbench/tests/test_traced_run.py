"""A traced run of the harness on the CPU, on small cells: the result line
carries the program's own counters, and the shares of the card's idle time
and the superstep turn read nothing where no device event was recorded."""

import json

import pytest

import run as bench_run


def _run(capsys, cell, trace, seed=123456789012):
    rc = bench_run.main(["--workload", cell, "--seed", str(seed),
                         "--seconds", "0", "--trace", str(trace)],
                        device="cpu")
    out, err = capsys.readouterr()
    assert rc == 0, err
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", ["small-awgn.pool", "small-bsc.stream"])
def test_a_traced_run_reads_the_programs_counters_and_spans(small_bench,
                                                            capsys, cell):
    # on the CPU the trace holds no device event and the program times no
    # turn: the shares of the card's idle time and turn_ms read nothing
    result = _run(capsys, cell, trace=1)
    assert result["correct"], result["checks"]
    names = set(result["metrics"])
    assert "superstep.drain_share" in names
    assert ("stream.stage_ms" in names) == cell.endswith(".stream")
    assert not names & {"superstep.turn_ms", "superstep.idle_share",
                        "driver.idle_share", "device.idle_share"}
    assert 0 < result["metrics"]["superstep.drain_share"]["value"] <= 100
