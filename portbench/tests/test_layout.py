"""BENCHMARK.json and the files it names: every configuration, traffic mix,
entry, channel, reference and metric reader is found by its name, and
each has what the harness reads from it."""

import json
import os

import pytest

from pbcore import cell

BENCH = cell.benchmark()
CONFIG_KEYS = {"source", "code_entry", "code_args", "code_kwargs",
               "code_alist", "n_vars", "n_checks",
               "n_edges", "n_punctured", "Z", "channel", "noise",
               "algorithm", "message_dtype", "B", "check_period",
               "first_check", "max_iterations", "phi_floor", "reference",
               "control_message_dtype", "limits", "assumed", "reduced"}


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_each_cell_finds_its_files(w):
    cfg = cell.config(BENCH, w["config"])
    assert CONFIG_KEYS <= set(cfg)
    assert cell.reference(cfg["reference"]).decode
    ch = cell.channel(cfg["channel"])
    assert ch.PROGRAM and ch.values and ch.llr
    mix = cell.traffic(w["traffic"])
    entry = cell.entry(mix["entry"])
    assert entry.make_bank and entry.warm_up and entry.window
    size = mix["call_frames" if mix["entry"] == "pool" else "chunk_frames"]
    assert mix["bank_frames"] % size == 0
    assert w["chips"] == 1
    for kind in ("end_to_end", "per_layer"):
        assert cell.metrics_of(BENCH, kind, w["name"])


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_each_per_layer_metric_has_a_reader(m):
    assert callable(cell.reader(m["name"]))
    assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}


@pytest.mark.parametrize("m", BENCH["end_to_end"], ids=lambda m: m["name"])
def test_each_end_to_end_metric_has_a_reader(m):
    assert callable(cell.reader(m["name"], "end_to_end"))


def test_the_contracts_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert os.path.exists(os.path.join(cell.ROOT, BENCH["command"][1]))
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    for c in BENCH["configs"]:
        assert c["file"].startswith("portbench/")
        assert json.load(open(os.path.join(cell.ROOT, c["file"])))[
            "reduced"] == c["reduced"]
