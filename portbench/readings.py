#!/usr/bin/env python3
"""The readings that a cell's limits are set from, in one process.

    python3 portbench/readings.py --workload p41-awgn.pool \\
        --seeds 11,12,13 --control-seeds 21,22,23

For each seed of ``--seeds`` the program, as the configuration states it,
decodes the cell's bank through the window's own entry (one pass over the
bank, at the cell's own sizes), and the plain reference judges the sampled
answers as a run does; for each of ``--control-seeds`` the same with the
control: the program's own lower-precision path
(``control_message_dtype`` of the configuration, float8_e5m2 for a
bfloat16 configuration). One JSON line per reading, then a summary: each
number's largest reading over the program's seeds (the lower reading) and
its smallest over the control's (the upper reading). The decoder, the code
and its graph are loaded once per precision.
"""

import argparse
import gc
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import run as bench_run  # noqa: E402


def readings(workload: str, seeds, control_seeds, device="cuda",
             log=print) -> dict:
    import torch

    from pbcore import cell, drive

    bench = cell.benchmark()
    w = cell.workload(bench, workload)
    cfg, mix = cell.config(bench, w["config"]), cell.traffic(w["traffic"])
    out = {"program": [], "control": []}
    for side, dtype, side_seeds in (
            ("program", None, seeds),
            ("control", cfg["control_message_dtype"], control_seeds)):
        if not side_seeds:
            continue
        prog, graph, buckets = bench_run.setup_program(cfg, device, dtype)
        for seed in side_seeds:
            t0 = time.perf_counter()
            b, win, answers, info = bench_run.measure(
                prog, graph, buckets, cfg, mix, seed, 0.0, False, device)
            del b.groups
            gc.collect()
            if torch.device(device).type == "cuda":
                torch.cuda.empty_cache()
            t1 = time.perf_counter()
            checks = bench_run.judge(cfg, buckets, b, answers, prog.batch,
                                     device)
            rec = {"side": side, "message_dtype": dtype or
                   cfg["message_dtype"], "seed": seed,
                   "correct": drive.passed(checks),
                   "frames": win.frames, "window_s": win.seconds,
                   "answers": checks["_answers"],
                   "iter_gap_signed": checks["_iter_gap_signed"],
                   "reference_mean_count": checks["_ref_mean_count"],
                   "reference_unsolved": checks["_ref_unsolved"],
                   "capped": sum(int((st.iterations >= cfg["max_iterations"])
                                     .sum()) for st in win.stats),
                   "reference_s": time.perf_counter() - t1,
                   "seed_s": time.perf_counter() - t0,
                   **{k: v["value"] for k, v in checks.items()
                      if not k.startswith("_")}}
            out[side].append(rec)
            log(json.dumps(rec))
        del prog
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    names = [k for k in out["program"][0] if k in (
        "wrong_words", "missing", "abs_iter_gap")] if out["program"] else []
    out["summary"] = {k: {
        "lower": max(r[k] for r in out["program"]),
        "upper": (min(r[k] for r in out["control"]) if out["control"]
                  else None)} for k in names}
    log(json.dumps({"workload": workload, "summary": out["summary"]}))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args()

    def ints(s):
        return [int(x) for x in s.split(",") if x]

    import torch

    if not torch.cuda.is_available():
        print("readings: no CUDA card", file=sys.stderr)
        return 2
    print(bench_run.card_line(), flush=True)
    readings(args.workload, ints(args.seeds), ints(args.control_seeds),
             log=lambda s: print(s, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
