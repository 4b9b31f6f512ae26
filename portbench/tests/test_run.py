"""A whole run of the harness on the CPU, on small cells: the result line,
the checks at its end, the refusal to run without a card, and each fault
of the timed path that a cell can have coming out as not correct."""

import json

import numpy as np
import pytest
import torch

import run as bench_run

CELLS = ["small-awgn.pool", "small-awgn.stream", "small-bsc.pool",
         "small-bsc.stream"]


def _run(capsys, cell, trace=0, seed=123456789012):
    rc = bench_run.main(["--workload", cell, "--seed", str(seed),
                         "--seconds", "0", "--trace", str(trace)],
                        device="cpu")
    out, err = capsys.readouterr()
    assert rc == 0, err
    return json.loads(out.strip().splitlines()[-1]), err


@pytest.mark.parametrize("cell", CELLS)
def test_a_run_is_correct(small_bench, capsys, cell):
    result, err = _run(capsys, cell)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    assert set(result) >= {"correct", "attempted", "failed", "metrics",
                           "device"}
    names = set(result["metrics"])
    assert {"decoded_mbps", "setup_s"} <= names
    assert ("chunk_latency_p90_ms" in names) == cell.endswith(".stream")
    last = err.strip().splitlines()[-3:]
    assert [line.split()[1] for line in last] == list(result["checks"])
    assert result["attempted"] >= 64


def test_readings_on_the_cpu(small_bench, capsys):
    import readings

    out = readings.readings("small-awgn.pool", [5, 6], [7], device="cpu",
                            log=lambda s: None)
    assert [r["seed"] for r in out["program"]] == [5, 6]
    assert all(r["correct"] for r in out["program"])
    assert out["summary"]["abs_iter_gap"]["lower"] == 0.0
    assert out["control"][0]["message_dtype"] == "float8_e5m2"


def test_no_card_no_result(small_bench, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = bench_run.main(["--workload", "small-awgn.pool", "--seed", "1",
                         "--seconds", "1"])
    out, err = capsys.readouterr()
    assert rc != 0 and out == "" and "CUDA" in err


def _state_unchanged(dec):
    run = dec._run_iterations

    def step(msgs, llr, syn, tables, k, pre, **kw):
        copy = tuple(m.clone() for m in msgs)
        _, bits, violated = run(copy, llr, syn, tables, k, pre, **kw)
        return msgs, bits, violated

    dec._run_iterations = step


def _half_the_batch(dec):
    presorted = dec.decode_presorted

    def half(dyn, n, values, syn, **kw):
        h = max(1, n // 2)
        words, st = presorted(dyn, h, values[:, :h].contiguous(),
                              syn[:, :h].contiguous(), **kw)
        full = torch.zeros((n, words.shape[1]), dtype=words.dtype)
        full[:h] = torch.as_tensor(words)
        st.iterations = np.concatenate(
            [st.iterations, np.full(n - h, int(st.iterations.mean()),
                                    st.iterations.dtype)])
        return full, st

    dec.decode_presorted = half


def _answer_altered(dec):
    pack = dec._pack

    def altered(bits):
        words = pack(bits)
        words[:, 0] ^= 1
        return words

    dec._pack = altered


@pytest.mark.parametrize("cell", ["small-awgn.pool", "small-bsc.stream"])
@pytest.mark.parametrize("fault", [_state_unchanged, _half_the_batch,
                                   _answer_altered],
                         ids=lambda f: f.__name__.strip("_"))
def test_a_broken_timed_path_is_not_correct(small_bench, capsys, monkeypatch,
                                            cell, fault):
    from pbcore import program

    load = program.load

    def broken(*a, **kw):
        prog = load(*a, **kw)
        fault(prog.decoder)
        return prog

    monkeypatch.setattr(program, "load", broken)
    result, _ = _run(capsys, cell)
    assert not result["correct"], result["checks"]
