"""Time the general path's float8_e5m2 sum-product kernels of two checkouts
of the port on one card.

    python3 scripts/compare_general_fp8_torch.py OTHER [OTHER ...] [--reps N]

Each OTHER is the root of another checkout (a parent commit unpacked with
``git archive``, or a variant of this one). Every checkout's general
library is built first, all at once. Then, in turns, each OTHER, this
checkout, this checkout, each OTHER in reverse order, each in a process
of its own that imports that checkout's
``ldpc_decoder_tpu_torch``: the general cell (``make_regular_code(2**20,
3, 6, seed=9)``, BI-AWGN at sigma = 0.84, B = 384 frames from index 0,
float8_e5m2 messages on a bfloat16 llr), four iterations on the accurate
phi (the same kernels in both checkouts, so the same state: its checksum
is compared across turns), then the check and the variable pass that the
decoder launches, each timed by the checkout's ``perf.cuda_ms`` (N
runs, default 10; the variable pass without emit), the checksums of their
outputs, and, where the checkout has them, their plain twins bit for bit.
One JSON line per turn, labelled ``this`` or by the OTHER's directory
name, with the card's name and power limit and this checkout's byte
bounds (``runtime/perf.py`` general_bytes). Needs a card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 384
SIGMA = 0.84


def checksum(torch, x) -> int:
    """A sum of the bytes' positions times their values (order-sensitive)."""
    b = x.reshape(-1).view(torch.uint8).to(torch.int64)
    w = torch.arange(1, b.numel() + 1, device=b.device, dtype=torch.int64)
    return int(((b * (w % 65521)) % 2**61).sum())


def child(tree: str, label: str, turn: int, reps: int) -> None:
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    from ldpc_decoder_tpu_torch.channels import BIAWGNChannel
    from ldpc_decoder_tpu_torch.codes.compiled import compile_code
    from ldpc_decoder_tpu_torch.codes.generate import make_regular_code
    from ldpc_decoder_tpu_torch.ops import general as G
    from ldpc_decoder_tpu_torch.runtime import perf
    from ldpc_decoder_tpu_torch.runtime.datagen import create_data

    assert G.__file__.startswith(tree + os.sep), G.__file__
    dev = torch.device("cuda")
    fp8 = torch.float8_e5m2
    code = make_regular_code(2**20, 3, 6, seed=9)
    t = G.GeneralTables.from_compiled(compile_code(code), dev)
    ch = BIAWGNChannel(SIGMA)
    batch = create_data(code, ch, 0, B, backend="native")
    vals = torch.from_numpy(np.ascontiguousarray(
        batch.values[t.vn_order.cpu().numpy(), :B])).to(dev)
    llr = ch.llr_from_channel(vals).masked_fill(
        t.erased_mask_sorted, 0.0).to(torch.bfloat16)
    syn = torch.from_numpy(np.ascontiguousarray(
        batch.syndromes[t.cn_order.cpu().numpy(), :B])).to(dev)
    mv, rc = G.init_messages_general(llr, t, fp8)
    for _ in range(4):
        G.cn_pass_general(mv, syn, rc, t, _phi="accurate")
        G.vn_pass_general(rc, llr, mv, t, _phi="accurate")
    torch.cuda.synchronize()
    rk, mk = torch.empty_like(rc), torch.empty_like(mv)
    G.cn_pass_general(mv, syn, rk, t)
    G.vn_pass_general(rc, llr, mk, t)
    rec = {"tree": label, "turn": turn,
           "state": [checksum(torch, mv), checksum(torch, rc)],
           "out": [checksum(torch, rk), checksum(torch, mk)]}
    if hasattr(G, "cn_pass_general_e5m2_plain"):
        rp = G.cn_pass_general_e5m2_plain(mv, syn, torch.empty_like(rc), t)
        bits_k = torch.empty((t.n_vars, B), dtype=torch.int8, device=dev)
        bits_p = torch.empty_like(bits_k)
        mp = G.vn_pass_general_e5m2_plain(rc, llr, torch.empty_like(mv), t,
                                          bits=bits_p)
        G.vn_pass_general(rc, llr, torch.empty_like(mv), t, bits=bits_k)
        rec["twin_bitwise"] = (perf.bit_identical(rk, rp)
                               and perf.bit_identical(mk, mp)
                               and torch.equal(bits_k, bits_p))
        del rp, mp
    rec["cn_ms"] = perf.cuda_ms(lambda: G.cn_pass_general(mv, syn, rk, t),
                                reps)
    rec["vn_ms"] = perf.cuda_ms(lambda: G.vn_pass_general(rc, llr, mk, t),
                                reps)
    print(json.dumps(rec), flush=True)


def build(tree: str) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
         "from ldpc_decoder_tpu_torch.ops import _kernels; "
         "_kernels.library_path('general')", tree], cwd=tree)


def main(argv: list[str]) -> int:
    if argv[:1] == ["--child"]:
        child(argv[1], argv[2], int(argv[3]), int(argv[4]))
        return 0
    reps = 10
    if "--reps" in argv:
        i = argv.index("--reps")
        reps = int(argv[i + 1])
        argv = argv[:i] + argv[i + 2:]
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    others = [(os.path.basename(os.path.abspath(a)), os.path.abspath(a))
              for a in argv]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    smi = smi.strip().splitlines()[0]
    builds = [build(tree) for _, tree in others + [("this", HERE)]]
    if any(p.wait() != 0 for p in builds):
        raise SystemExit("building a general library failed")
    sys.path.insert(0, HERE)
    from ldpc_decoder_tpu_torch.codes.compiled import compile_code
    from ldpc_decoder_tpu_torch.codes.generate import make_regular_code
    from ldpc_decoder_tpu_torch.ops.general import GeneralTables
    from ldpc_decoder_tpu_torch.runtime import perf

    t = GeneralTables.from_compiled(compile_code(make_regular_code(
        2**20, 3, 6, seed=9)), "cpu")
    passes = perf.general_bytes(t, B, 1, 2)
    bound = {k: perf.bound(v)[0] for k, v in passes.items()}
    state = None
    turns = others + [("this", HERE), ("this", HERE)] + others[::-1]
    for turn, (label, tree) in enumerate(turns):
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", tree,
             label, str(turn), str(reps)], check=True, cwd=tree,
            stdout=subprocess.PIPE, text=True).stdout
        for line in out.splitlines():
            rec = json.loads(line)
            state = state or rec["state"]
            assert rec["state"] == state, f"turn {turn}: another state"
            rec.update(card=smi, cn_bound_ms=bound["cn"],
                       vn_bound_ms=bound["vn"],
                       cn_share=bound["cn"] / rec["cn_ms"],
                       vn_share=bound["vn"] / rec["vn_ms"])
            print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
