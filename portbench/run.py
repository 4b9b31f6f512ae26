#!/usr/bin/env python3
"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python3 portbench/run.py --workload p41-awgn.pool --seed 7 \\
        --seconds 30 --trace 0

from the root of a checkout, on a machine with an NVIDIA GPU. The run
loads the cell's configuration and traffic mix (``pbcore.cell``), makes
its frames from ``--seed`` on the card, warms up and measures for
``--seconds`` through the entry the mix names (``entries/<name>.py``),
judges the sampled answers against the plain reference (``pbcore.drive``)
and prints one JSON object as its last line:
``correct``, ``attempted`` (frames decoded in the window), ``failed``
(frames the decoder gave up on at its iteration cap), ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number compared beside its limit, which also end standard error. Earlier
lines say what the numbers rest on: the card, its clocks and power limit,
the counts behind each rate and tail, and the reference's formula of
decoding Mb/s.

Exits 2, printing no result, without enough CUDA cards, and 3 if JAX or
the JAX package was imported. Writes only to ``portbench/.cache`` and,
on a first run, the program's own caches inside the checkout.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

MIB = 1 << 20


def log(*parts) -> None:
    print(*parts, flush=True)


def card_line() -> str:
    """nvidia-smi's name, power limit and clocks of the first card."""
    q = ("name,power.limit,power.draw,clocks.sm,clocks.max.sm,clocks.mem,"
         "temperature.gpu")
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return f"{q}: {out.stdout.strip().splitlines()[0]}"
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"nvidia-smi unavailable ({e})"


@dataclass
class RunView:
    """What a metric's reader (``end_to_end/<name>.py``,
    ``metrics/<name>.py``) reads."""

    cfg: dict
    graph: object
    window: object          # pbcore.drive.Window
    window_peak_bytes: int
    setup_s: float


def setup_program(cfg: dict, device, message_dtype=None):
    """(program, graph, buckets): the port's decoder, and the code as the
    benchmark reads it from the same alist, checked against each other
    and against the sizes the configuration states."""
    from pbcore import cell, program
    from pbcore.graph import Buckets, load_graph

    prog = program.load(cfg, device, message_dtype)
    graph = load_graph(program.alist_path(cfg), cell.CACHE_DIR)
    code = prog.decoder.code
    stated = (cfg["n_vars"], cfg["n_checks"], cfg["n_edges"],
              cfg["n_punctured"])
    for name, got in (("benchmark's alist reading", (
            graph.n_vars, graph.n_checks, graph.n_edges, graph.n_punctured)),
            ("program's code", (code.n_vars, code.n_checks, code.n_edges,
                                code.n_erased_vars))):
        if got != stated:
            raise RuntimeError(f"the {name} {got} differs from the "
                               f"configuration's (n_vars, n_checks, "
                               f"n_edges, n_punctured) {stated}")
    return prog, graph, Buckets.of(graph, device)


def measure(prog, graph, buckets, cfg, mix, seed, seconds, trace, device,
            t_start=None):
    """One run on a program already loaded: bank, warm-up, window. Returns
    (bank, window, answers, info) with the program's pools still held."""
    import torch

    from pbcore import cell, drive

    cuda = torch.device(device).type == "cuda"
    entry = cell.entry(mix["entry"])
    t0 = time.perf_counter()
    b = entry.make_bank(prog, graph, buckets, cfg, mix, seed, device)
    t1 = time.perf_counter()
    entry.warm_up(prog, b, mix)
    if cuda:
        torch.cuda.synchronize()
    t2 = time.perf_counter()
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    answers = drive.Answers(b.sample, b.group_frames, b.answers_device)
    t_window = time.perf_counter()
    win = entry.window(prog, b, mix, seconds, trace, answers)
    info = {
        "setup_s": t_window - (t_start if t_start is not None else t0),
        "bank_s": t1 - t0, "warm_up_s": t2 - t1,
        "setup_peak_bytes": setup_peak,
        "window_peak_bytes": torch.cuda.max_memory_allocated() if cuda else 0,
    }
    return b, win, answers, info


def judge(cfg, buckets, b, answers, B, device):
    from pbcore import cell, drive

    return drive.judge(cell.reference(cfg["reference"]), buckets, b, answers,
                       cfg, B, device)


def main(argv=None, device=None) -> int:
    """``device``: None looks for the CUDA cards the cell asks for; the
    tests pass "cpu" to drive the rest of a run without a card."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from pbcore import cell, drive
    from pbcore.imports import forbidden_loaded

    bench = cell.benchmark()
    w = cell.workload(bench, args.workload)
    cfg, mix = cell.config(bench, w["config"]), cell.traffic(w["traffic"])
    if device is None:
        if (not torch.cuda.is_available()
                or torch.cuda.device_count() < w["chips"]):
            print(f"portbench: {args.workload} needs {w['chips']} CUDA "
                  f"card(s); torch sees "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = "cuda"
    trace = bool(args.trace)
    prog, graph, buckets = setup_program(cfg, device)
    B, code_how = prog.batch, prog.code_how
    b, win, answers, info = measure(prog, graph, buckets, cfg, mix,
                                    args.seed, args.seconds, trace, device,
                                    T_START)
    view = RunView(cfg, graph, win, info["window_peak_bytes"],
                   info["setup_s"])
    # the program's state goes before the reference runs
    del b.groups, prog
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    checks = judge(cfg, buckets, b, answers, B, device)

    n_vars = cfg["n_vars"]
    iters = sum(int(st.iterations.sum()) for st in win.stats)
    slots = sum(st.total_iterations * st.batch_size for st in win.stats)
    clocks = sum(st.decode_seconds if st.decode_seconds is not None
                 else st.elapsed_seconds for st in win.stats)
    avg_iter = iters / win.frames
    itpv = clocks / slots
    capped = sum(int((st.iterations >= cfg["max_iterations"]).sum())
                 for st in win.stats)
    log(card_line())
    log(json.dumps({
        "workload": args.workload, "seed": args.seed, "trace": args.trace,
        "device": device, "code": f"{cfg['code_entry']} ({code_how})",
        "entry": mix["entry"], "calls": win.calls,
        "frames": win.frames, "window_s": win.seconds,
        "latency_samples": len(win.latencies),
        "traced_calls": win.traced_calls,
        "sampled_frames": int(b.sample.size),
        "sampled_answers": checks["_answers"],
        "avg_iterations": avg_iter,
        "iter_gap_signed": checks["_iter_gap_signed"],
        "reference_mean_count": checks["_ref_mean_count"],
        "reference_unsolved": checks["_ref_unsolved"],
        "decoding_mbps_reference_formula": n_vars / (avg_iter * itpv * MIB),
        "bank_s": info["bank_s"], "warm_up_s": info["warm_up_s"],
        "setup_peak_bytes": info["setup_peak_bytes"],
        "window_peak_bytes": info["window_peak_bytes"]}))

    metrics = {}
    kind = "per_layer" if trace else "end_to_end"
    for m in cell.metrics_of(bench, kind, args.workload):
        value = cell.reader(m["name"], kind)(view)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                    else "cpu"),
           "count": w["chips"],
           "memory_peak_bytes": max(info["setup_peak_bytes"],
                                    info["window_peak_bytes"])}
    result = {"correct": drive.passed(checks), "attempted": win.frames,
              "failed": capped, "metrics": metrics, "device": dev}
    if win.trace is not None:
        dev["busy_s"] = win.trace.busy_s
        dev["window_s"] = win.trace.window_s
        result["breakdown"] = {"device_ops": win.trace.top_ops(),
                               "idle_gaps": win.trace.idle_gaps()}
    result["checks"] = {k: v for k, v in checks.items()
                        if not k.startswith("_")}

    found = forbidden_loaded()
    if found:
        print(f"portbench: the run imported {found}; no result",
              file=sys.stderr)
        return 3
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']} limit {v['limit']}", file=sys.stderr)
    sys.stderr.flush()
    log(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
