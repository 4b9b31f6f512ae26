"""Time the frame-pool kernels of two checkouts of the port on one card.

    python3 scripts/compare_datagen_torch.py OTHER

OTHER is the root of another checkout (a parent commit unpacked with
``git archive``). D1 (``chacha_bits``, the reference bits and packed
words) and D2 (``channel_values``, the channel values in the decoder's
sorted order) of ``csrc/datagen.cu`` run at four points, as
``chip_smoke.py`` phases 31-32 and ``create_pool_device``'s default chunk
give them: p41 x 512 BI-AWGN, reg36 x 512 erasure, reg36 x 512 BSC and
p41 x 64 BI-AWGN (the first 2B = 512 frames of a qualification pool, and
its 64-frame chunk). The inputs (sizes, erased tail, the decoder's
natural -> sorted rows) are made once by this checkout; the checkouts then
run in turns, OTHER, this checkout, this checkout, OTHER, each in a
process of its own that imports that checkout's ``ldpc_decoder_tpu_torch``
and builds its ``datagen`` library there, and each times through this
checkout's ``runtime/perf.py`` ``cuda_ms`` (median of 10 single launches
after a warm-up). Every turn's outputs must agree bit for bit with the
first turn's (a checksum each). Prints the card's name and power limit,
one JSON line per (turn, point, kernel) with the bound and share from this
checkout's ``perf.py``, and each checkout's SASS split of its pool kernels
(``chip_smoke.py`` ``datagen_sass_split``). Needs a card.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PERF = os.path.join(HERE, "ldpc_decoder_tpu_torch", "runtime", "perf.py")
# (point, code, channel, noise, frames)
POINTS = (("p41 x 512 BI-AWGN", "p41", "awgn", 0.94, 512),
          ("reg36 x 512 erasure", "reg36", "erasure", 0.40, 512),
          ("reg36 x 512 BSC", "reg36", "bsc", 0.05, 512),
          ("p41 x 64 BI-AWGN", "p41", "awgn", 0.94, 64))
START = 0


def _this_perf():
    spec = importlib.util.spec_from_file_location("_this_perf", PERF)
    mine = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mine)
    return mine


def checksum(torch, x) -> int:
    """A position-weighted sum of ``x``'s 32-bit words, on the card."""
    w = x.reshape(-1).view(torch.int32).to(torch.int64)
    idx = torch.arange(w.numel(), device=w.device) % 1000003 + 1
    return int((w * idx).sum())


def make_inputs(path: str) -> None:
    """Each point's (n_vars, n_tx, pos) from this checkout's qualification
    decoders (``scripts/fer_stats_torch.py``), saved to ``path``."""
    import torch

    sys.path.insert(0, HERE)
    from ldpc_decoder_tpu_torch.codes.samples import get_code, get_reg36_code
    from ldpc_decoder_tpu_torch.runtime.datagen_device import _pool_tables

    spec = importlib.util.spec_from_file_location(
        "fer_stats_torch", os.path.join(HERE, "scripts", "fer_stats_torch.py"))
    fer = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fer)
    dev = torch.device("cuda")
    codes = {"p41": get_code()[:2], "reg36": get_reg36_code()[:2]}
    idx = {"awgn": 0, "bsc": 1, "erasure": 2}
    inputs = {}
    for name, code_name, channel, noise, _ in POINTS:
        code, s = codes[code_name]
        dec, _ = fer.qualification_decoder(code, s, idx[channel], noise, dev)
        inputs[name] = (code.n_vars, code.n_vars - code.n_erased_vars,
                        _pool_tables(dec).pos.cpu())
        del dec
        torch.cuda.empty_cache()
    torch.save(inputs, path)


def child(tree: str, label: str, turn: int, inputs_path: str) -> None:
    sys.path.insert(0, tree)
    import torch

    from ldpc_decoder_tpu_torch.ops import _kernels
    from ldpc_decoder_tpu_torch.rng import chacha_torch as ct

    assert ct.__file__.startswith(tree + os.sep), ct.__file__
    perf = _this_perf()
    dev = torch.device("cuda")
    inputs = torch.load(inputs_path)
    print(json.dumps({"tree": label, "turn": turn,
                      "library": _kernels.library_path("datagen")}),
          flush=True)
    for name, _, channel, noise, n in POINTS:
        n_vars, n_tx, pos = inputs[name]
        pos = pos.to(dev)
        bits, packed = ct.reference_bits_packed(START, n_vars, n, dev)
        vals = ct.channel_values(bits, START, channel, noise, n_tx=n_tx,
                                 pos=pos)
        torch.cuda.synchronize()
        sums = {"bits": checksum(torch, bits),
                "packed": checksum(torch, packed),
                "values": checksum(torch, vals)}
        d1 = perf.cuda_ms(
            lambda: ct.reference_bits_packed(START, n_vars, n, dev))
        d2 = perf.cuda_ms(
            lambda: ct.channel_values(bits, START, channel, noise,
                                      n_tx=n_tx, pos=pos, out=vals))
        print(json.dumps({"tree": label, "turn": turn, "point": name,
                          "chacha_bits_ms": d1, "channel_values_ms": d2,
                          "checksums": sums}), flush=True)
        del bits, packed, vals, pos
        torch.cuda.empty_cache()


def bounds(perf, channel: str, n_vars: int, n_tx: int, n: int) -> dict:
    """{kernel: {"bound_ms"[, "issue_bound_ms"]}} from this checkout's
    perf.py: bytes against integer operations on one integer pipe, and
    for D2 also against the instructions issued."""
    nb, ops = perf.chacha_bits_work(n_vars, n)
    n_bytes, n_int, n_issue = perf.channel_values_work(channel, n_vars,
                                                       n_tx, n)
    return {"chacha_bits": {
                "bound_ms": perf.bound(nb, ops, perf.INT32_OPS_PER_S)[0]},
            "channel_values": {
                "bound_ms": perf.bound(n_bytes, n_int,
                                       perf.INT32_OPS_PER_S)[0],
                "issue_bound_ms": perf.bound(n_bytes, n_issue,
                                             perf.ISSUE_OPS_PER_S)[0]}}


def main(argv: list[str]) -> int:
    if argv[:1] == ["--child"]:
        child(argv[1], argv[2], int(argv[3]), argv[4])
        return 0
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    other = os.path.abspath(argv[0])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    print(smi.strip().splitlines()[0], flush=True)
    perf = _this_perf()
    with tempfile.TemporaryDirectory() as tmp:
        inputs_path = os.path.join(tmp, "inputs.pt")
        subprocess.run([sys.executable, "-c",
                        "import sys; sys.path.insert(0, sys.argv[1]); "
                        "import compare_datagen_torch as c; "
                        "c.make_inputs(sys.argv[2])",
                        os.path.dirname(os.path.abspath(__file__)),
                        inputs_path], check=True, cwd=HERE)
        import torch

        inputs = torch.load(inputs_path)
        records, libraries, first = [], {}, {}
        for turn, (label, tree) in enumerate((("other", other),
                                              ("this", HERE), ("this", HERE),
                                              ("other", other))):
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--child", tree,
                 label, str(turn), inputs_path], check=True, cwd=tree,
                stdout=subprocess.PIPE, text=True).stdout
            for line in out.splitlines():
                rec = json.loads(line)
                if "library" in rec:
                    libraries[label] = rec["library"]
                    continue
                want = first.setdefault(rec["point"], rec["checksums"])
                assert rec["checksums"] == want, (
                    f"{label} turn {turn} {rec['point']}: outputs differ "
                    f"from the first turn's")
                records.append(rec)
    for rec in records:
        name = rec["point"]
        _, _, channel, _, n = next(p for p in POINTS if p[0] == name)
        n_vars, n_tx, _ = inputs[name]
        for kernel, b in bounds(perf, channel, n_vars, n_tx, n).items():
            ms = rec[f"{kernel}_ms"]
            shares = {f"{k[:-3]}_share": v / ms for k, v in b.items()}
            print(json.dumps({"tree": rec["tree"], "turn": rec["turn"],
                              "point": name, "kernel": kernel, "ms": ms,
                              **b, **shares}), flush=True)
    sys.path.insert(0, HERE)
    import chip_smoke

    for label, path in libraries.items():
        for fn in chip_smoke.sass_of(path).split("Function : ")[1:]:
            kernel = chip_smoke.datagen_kernel_label(fn.split(None, 1)[0])
            split = chip_smoke.datagen_sass_split(fn, kernel)
            print(json.dumps({"tree": label, "kernel": kernel,
                              "sass": split}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
