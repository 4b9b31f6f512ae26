"""A cell of ``BENCHMARK.json`` and the files it is made of, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix. The configuration's entry in ``configs`` gives its file (the code by
the program's constructor and its arguments, sizes, channel, schedule,
limits); the file names its channel, a module ``channels/<name>.py``, and
its plain reference, ``references/<name>.py``. The traffic mix is
``traffic/<name>.json``, parameters only; it names the entry of the
program that its window drives, ``entries/<name>.py``. An end-to-end
metric is ``end_to_end/<name>.py`` and a per-layer one
``metrics/<name>.py``, each with a ``read(run)`` that returns a number or
None. So a new cell, configuration, mix, entry, channel or metric is new
files and entries only.
"""

from __future__ import annotations

import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
CACHE_DIR = os.path.join(BENCH_DIR, ".cache")


def benchmark() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")


def config(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            with open(os.path.join(ROOT, c["file"])) as f:
                return json.load(f)
    raise KeyError(f"no config named {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    with open(os.path.join(BENCH_DIR, "traffic", f"{name}.json")) as f:
        return json.load(f)


_LOADED: dict = {}


def _module(folder: str, name: str):
    """``<folder>/<name>.py`` of the benchmark, loaded once."""
    if (folder, name) in _LOADED:
        return _LOADED[folder, name]
    path = os.path.join(BENCH_DIR, folder, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{folder}_{name.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    _LOADED[folder, name] = mod
    return mod


def reader(metric: str, kind: str = "per_layer"):
    """The ``read(run)`` of metric ``metric``: ``kind`` "per_layer" or
    "end_to_end"."""
    return _module({"per_layer": "metrics", "end_to_end": "end_to_end"}[kind],
                   metric).read


def entry(name: str):
    return _module("entries", name)


def channel(name: str):
    return _module("channels", name)


def reference(name: str):
    return _module("references", name)


def metrics_of(bench: dict, kind: str, cell: str) -> list:
    """The entries of ``bench[kind]`` ("end_to_end" or "per_layer") that
    cell ``cell`` reports: those without ``workloads`` and those that list
    it."""
    return [m for m in bench[kind]
            if cell in m.get("workloads", [cell])]
