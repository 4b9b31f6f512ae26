"""Time the retire kernel (``csrc/retire.cu``) on the card at the main
path's shapes.

    python3 scripts/retire_pack_torch.py [--out PATH]

At p41 x 256 and the rate-0.9 BSC code x 256 (the benchmark's two codes,
``codes/samples.py``; their decoders' ``_src_row``, bfloat16 sum-product)
and at a ragged general numbering x 256 (a random permutation of
RAGGED_VARS variables, the last word 3 bits), on random hard bits, for
L = 1, 64 (about what a superstep retires) and 256 lanes retiring into a
512-frame pool's results, it times

- ``card_ms``: the kernel alone (``_kernels.retire_pack``, its lane table
  on the card already), the mean of 50 launches in a row between CUDA
  events, after a warm-up (the median of three such means);
- ``call_ms``: the decoder's call (``ops.retire.pack_retired``: the lane
  table written into its pinned buffer, copied, and the kernel), the same
  way;
- ``plain_ms``: the plain version on the card (``pack_retired_plain``),
  ``runtime/perf.py`` ``cuda_ms``;
- ``library_ms``: the torch chain the kernel replaced (the lanes'
  columns gathered, whole Z-blocks permuted, ``pack_rows``' 32-step shift
  and OR over int64, the words scattered into the results by
  ``index_put_``, with its two index copies), ``cuda_ms``; for a
  numbering that is not whole Z-blocks the chain was the plain version
  itself (``library_ms`` = ``plain_ms``);

beside the bound (``perf.retire_pack_bytes`` over 3.35 TB/s) and the
kernel's share of it. Every route's results must equal the kernel's bit
for bit, one launch a call, rows no lane names untouched and the bits past
n_vars zero. ``chip_smoke.py`` runs :func:`measure` too. Prints the card's name and power limit, then one JSON line per
(code, L); ``--out`` also writes them as a JSON list. Needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from ldpc_decoder_tpu_torch.channels import BIAWGNChannel  # noqa: E402
from ldpc_decoder_tpu_torch.codes import samples  # noqa: E402
from ldpc_decoder_tpu_torch.ops import _kernels, retire  # noqa: E402
from ldpc_decoder_tpu_torch.rng.chacha_torch import pack_rows  # noqa: E402
from ldpc_decoder_tpu_torch.runtime import perf  # noqa: E402
from ldpc_decoder_tpu_torch.runtime.decoder import LDPCDecoder  # noqa: E402
from ldpc_decoder_tpu_torch.runtime.params import StaticParams  # noqa: E402

B = 256
N_POOL = 512
LANES = (1, 64, 256)
RUNS = 50
RAGGED_VARS = 1_000_003


def mean_ms(fn, runs: int = RUNS) -> float:
    """The median over three rounds of the mean milliseconds of ``fn()``
    over ``runs`` calls in a row between two CUDA events, after one
    warm-up call."""
    fn()
    means = []
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(runs):
            fn()
        b.record()
        b.synchronize()
        means.append(a.elapsed_time(b) / runs)
    return sorted(means)[1]


def torch_chain(bits, block_perm, Z, lanes, frames, results):
    """The retire the kernel replaced, for a block-aligned numbering."""
    dev = bits.device
    n_words = results.shape[1]
    cols = bits.view(-1, Z, B)[..., torch.from_numpy(lanes).to(dev)]
    packed = pack_rows(cols[block_perm].reshape(-1, lanes.size), n_words)
    results[torch.from_numpy(frames).to(dev)] = packed


def decoder_rows(code, s, dev) -> torch.Tensor:
    """The ``_src_row`` of the B = 256 bfloat16 decoder of ``code``."""
    dec = LDPCDecoder(code, BIAWGNChannel(0.9), StaticParams(
        parallel_factor_user=B, message_dtype="bfloat16"), qc=s,
        device=dev)
    return dec._src_row


def random_rows(n_vars: int, dev) -> torch.Tensor:
    """A general numbering: a random permutation of ``n_vars`` rows."""
    rows = np.random.default_rng(n_vars).permutation(n_vars)
    return torch.from_numpy(rows.astype(np.int32)).to(dev)


def measure(name: str, src_row: torch.Tensor, Z, dev,
            lanes_list=LANES) -> list[dict]:
    """The records of one numbering ``src_row`` (whole Z-blocks, or any
    permutation when ``Z`` is None), one per L of ``lanes_list``."""
    n_vars = src_row.numel()
    n_words = (n_vars + 31) // 32
    if Z is not None:
        vn_pos = src_row.cpu().numpy()
        block_perm = vn_pos[::Z] // Z
        assert np.array_equal(vn_pos.reshape(-1, Z),
                              block_perm[:, None] * Z + np.arange(Z))
        block_perm = torch.from_numpy(block_perm).to(dev)
    gen = torch.Generator(device=dev).manual_seed(n_vars)
    bits = torch.randint(0, 2, (n_vars, B), dtype=torch.int8, device=dev,
                         generator=gen)
    rng = np.random.default_rng(7)
    out = []
    for n in lanes_list:
        lanes = np.sort(rng.permutation(B)[:n])
        frames = rng.permutation(N_POOL)[:n]
        results = torch.zeros((N_POOL, n_words), dtype=torch.int32,
                              device=dev)
        staging = retire.RetireStaging(B, dev)
        before = _kernels.launch_counts["retire_pack"]
        retire.pack_retired(bits, src_row, lanes, frames, results, staging)
        torch.cuda.synchronize()
        assert _kernels.launch_counts["retire_pack"] == before + 1, name
        routes = [retire.pack_retired_plain]
        if Z is not None:
            routes.append(lambda *a: torch_chain(bits, block_perm, Z, lanes,
                                                 frames, a[-1]))
        for route in routes:
            other = torch.zeros_like(results)
            route(bits, src_row, lanes, frames, other)
            assert torch.equal(other, results), f"{name} L = {n}"
        if n_vars % 32:
            last = results[torch.from_numpy(frames).to(dev), -1]
            assert not (last >> (n_vars % 32)).any(), \
                f"{name} L = {n}: bits past n_vars"
        table = staging.table
        card = mean_ms(lambda: _kernels.retire_pack(
            bits, src_row, table, results, n_vars, n_words, B))
        call = mean_ms(lambda: retire.pack_retired(
            bits, src_row, lanes, frames, results, staging))
        plain = perf.cuda_ms(lambda: retire.pack_retired_plain(
            bits, src_row, lanes, frames, results), reps=5)
        library = plain if Z is None else perf.cuda_ms(lambda: torch_chain(
            bits, block_perm, Z, lanes, frames, results), reps=5)
        bound, bound_by = perf.bound(perf.retire_pack_bytes(n_vars, B,
                                                            lanes))
        out.append({"code": name, "n_vars": n_vars, "B": B, "lanes": n,
                    "card_ms": round(card, 4), "call_ms": round(call, 4),
                    "bound_ms": round(bound, 4), "bound_by": bound_by,
                    "share": round(bound / card, 4),
                    "plain_ms": round(plain, 3),
                    "library_ms": round(library, 3)})
        print(json.dumps(out[-1]), flush=True)
    del bits
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    print(smi.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda")
    records = []
    for name, get in (("p41", samples.get_code),
                      ("rate09", samples.get_bsc_code)):
        code, s, _ = get()
        records += measure(name, decoder_rows(code, s, dev), s.Z, dev)
    records += measure("ragged", random_rows(RAGGED_VARS, dev), None, dev)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": smi.strip(), "records": records}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
