"""Shared fixtures: two small codes of the port's two QC families, and a
benchmark of small cells on them that the harness drives on the CPU.

Run from the root of a checkout:

    python -m pytest portbench/tests -q            # CPU tests
    python -m pytest portbench/tests -q -m cuda    # on a machine with a card
"""

import json
import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)


def _small_codes(tmp):
    from ldpc_decoder_tpu_torch.codes.protographs import p41_code, regular_base
    from ldpc_decoder_tpu_torch.codes.qc import make_qc_code, write_qc_alist

    out = {}
    for name, build in (
            ("grouped", lambda: p41_code(Z=64, m=4, coarse=None, fine_mod=16)),
            ("regular", lambda: make_qc_code(
                regular_base(4, 40, 3, 30, seed=3), Z=256, seed=1,
                coarse=None, fine_mod=None, min_girth=6))):
        code, s = build()
        path = os.path.join(tmp, f"{name}.alist")
        write_qc_alist(code, s, path)
        out[name] = (code, s, path)
    return out


@pytest.fixture(scope="package")
def small_codes(tmp_path_factory):
    return _small_codes(str(tmp_path_factory.mktemp("codes")))


SMALL_CONFIGS = {
    "small-awgn": dict(family="grouped", channel="awgn", noise=0.8,
                       check_period=4, first_check=8, max_iterations=40),
    "small-bsc": dict(family="regular", channel="bsc", noise=0.004,
                      check_period=3, first_check=0, max_iterations=40),
}
SMALL_MIXES = {
    "pool": {"entry": "pool", "bank_frames": 96, "call_frames": 48,
             "sample_frames": 40, "trace_from": 0, "trace_count": 1},
    "stream": {"entry": "stream", "bank_frames": 64, "chunk_frames": 16,
               "depth": 2, "sample_frames": 40, "trace_from": 0,
               "trace_count": 1},
}


@pytest.fixture
def small_bench(small_codes, monkeypatch, tmp_path):
    """BENCHMARK.json's cells on the small codes: the port's sample entry
    points and the benchmark's files swapped for small ones."""
    from ldpc_decoder_tpu_torch.codes import samples

    from pbcore import cell

    configs = []
    for name, c in SMALL_CONFIGS.items():
        code, s, path = small_codes[c["family"]]
        entry = f"small_{c['family']}"
        monkeypatch.setattr(samples, entry,
                            lambda code=code, s=s: (code, s, "cache"),
                            raising=False)
        monkeypatch.setattr(samples, entry.upper(), path, raising=False)
        cfg = {"code_entry": f"codes.samples.{entry}", "code_args": [],
               "code_kwargs": {},
               "code_alist": f"codes.samples.{entry.upper()}",
               "n_vars": code.n_vars, "n_checks": code.n_checks,
               "n_edges": code.n_edges, "n_punctured": code.n_erased_vars,
               "Z": s.Z, "algorithm": "sum-product",
               "message_dtype": "float32", "B": 16, "phi_floor": 1e-5,
               "reference": "flood_f32", "limits": {"abs_iter_gap": 0.5},
               "control_message_dtype": "float8_e5m2",
               **{k: v for k, v in c.items() if k != "family"}}
        f = tmp_path / f"{name}.json"
        f.write_text(json.dumps(cfg))
        configs.append({"name": name, "source": "test", "file": str(f),
                        "reduced": [], "why": "test"})
    real = cell.benchmark()
    bench = dict(real, configs=configs, workloads=[
        {"name": f"{c}.{m}", "config": c, "traffic": m, "chips": 1,
         "why": "test"} for c in SMALL_CONFIGS for m in SMALL_MIXES])
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:  # the same traffic mixes on the small configs
            mixes = {w.rsplit(".", 1)[1] for w in m["workloads"]}
            m["workloads"] = [f"{c}.{t}" for c in SMALL_CONFIGS
                              for t in sorted(mixes)]
    monkeypatch.setattr(cell, "benchmark", lambda: bench)
    monkeypatch.setattr(cell, "traffic", lambda name: dict(SMALL_MIXES[name]))
    monkeypatch.setattr(cell, "CACHE_DIR", str(tmp_path / "cache"))
    # several blocks of the reference's at these sizes
    monkeypatch.setattr(cell.reference("flood_f32"), "BLOCK_FRAMES", 16)
    return bench
