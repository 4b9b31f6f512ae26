"""Interleaved-alist speed benchmark on the PyTorch/CUDA port.

The port's counterpart of ``scripts/bench_interleaved.py``: the README's
regular (3,6) 2^20 QC code (``codes/samples.py`` ``get_reg36_code``) as the
aligned control, and the same code renumbered lift-index-first
(``interleave_code_numbering(code, Z)``), decoded with ``qc=None`` so that
the decoder's permuted detection has to recover the structure and run the
regular QC kernels. bfloat16 sum-product at sigma 0.87, k = 10, first check
0, at most 120 iterations, B <= 256 lanes, loading factor max(2, frames /
B); each decoder decodes a pool generated on its device (``bench.py``
``run_point``'s protocol: the second decode is the one reported), and the
script prints both decoding rates and their ratio.

In addition the same frames go through both decoders: the aligned code's
host batch, and that batch renumbered through ``to_new_v`` / ``to_new_c``
for the interleaved one. The decoded words, mapped back, and the per-frame
iterations must be equal.

    python scripts/bench_interleaved_torch.py [sigma] [frames]
        [--device cpu]

It runs on the card; ``--device cpu`` runs the plain PyTorch versions on the
CPU (slow at this size; the tests call :func:`run` on a small code).
Without a card, ``--device cuda`` exits 1.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

MAX_ITER = 120
CHECK_PERIOD = 10
CPU_MEMORY_BYTES = 1 << 30


def make_decoder(code, qc, sigma: float, device):
    """bench.py's decoder of ``run_point`` at this script's settings:
    bfloat16 sum-product, B <= 2^8 lanes; ``qc`` None detects the
    structure."""
    import torch

    from ldpc_decoder_tpu_torch.channels import BIAWGNChannel
    from ldpc_decoder_tpu_torch.runtime.decoder import LDPCDecoder
    from ldpc_decoder_tpu_torch.runtime.params import StaticParams

    device = torch.device(device)
    memory = CPU_MEMORY_BYTES if device.type == "cpu" else None
    return LDPCDecoder(code, BIAWGNChannel(sigma), StaticParams(
        max_log_parallel_factor_user=8, message_dtype="bfloat16",
        device_memory_bytes=memory), qc=qc, device=device)


def dynamic_params(dec, n_frames: int):
    """(DynamicParams, frames) of ``run_point``: k = 10, first check 0,
    loading factor max(2, ceil(n_frames / B)), frames a multiple of 32."""
    from ldpc_decoder_tpu_torch.runtime.params import DynamicParams

    B = dec.parallel_factor()
    lf = max(2, -(-n_frames // B))
    dyn = DynamicParams(num_iter_max=MAX_ITER,
                        num_iter_check_parity=CHECK_PERIOD,
                        num_iter_first_check=0, loading_factor=lf,
                        target_errors=15)
    return dyn, (min(n_frames, B * lf) // 32) * 32


def rates(dec, stats, n: int) -> tuple[float, float]:
    """(decoding Mb/s, e2e Mb/s) of a decode of ``n`` frames (bench.py's
    formulas)."""
    bits = dec.code.n_vars
    dec_mbps = bits / (stats.avg_iter * stats.iter_time_per_vector
                       * 1048576.0)
    return dec_mbps, bits * n / 1048576.0 / stats.elapsed_seconds


def run_point(dec, n_frames: int, label: str, log=print) -> dict:
    """``bench.py`` ``run_point`` on the port: a pool of frames 0 .. n made
    on the decoder's device, decoded twice, the second reported."""
    import torch

    from ldpc_decoder_tpu_torch.runtime.datagen_device import (
        count_bit_errors,
        create_pool_device,
    )

    dyn, n = dynamic_params(dec, n_frames)

    def sync():
        if dec.device.type == "cuda":
            torch.cuda.synchronize(dec.device)

    t0 = time.perf_counter()
    pool = create_pool_device(dec, dec.channel, 0, n)
    sync()
    log(f"  {label}: B={dec.parallel_factor()} frames={n}, on-device "
        f"datagen {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    dec.decode_presorted(dyn, n, pool.values_sorted, pool.syn_sorted,
                         fetch_results=False)
    sync()
    log(f"  {label}: decode 1 {time.perf_counter() - t0:.1f}s")
    results, stats = dec.decode_presorted(
        dyn, n, pool.values_sorted, pool.syn_sorted, fetch_results=False)
    errors = count_bit_errors(results, pool.ref_packed).cpu().numpy()
    dec_mbps, e2e_mbps = rates(dec, stats, n)
    return {"dec_mbps": dec_mbps, "e2e_mbps": e2e_mbps,
            "fer1": float((errors > 0).mean()),
            "ber": float(errors.sum()) / (dec.code.n_vars * n),
            "avg_iters": stats.avg_iter, "max_iters": stats.max_iter,
            "B": dec.parallel_factor(), "n": n}


def renumbered(batch, to_v, to_c):
    """The batch's (values, syndromes) in the interleaved numbering."""
    vals = np.empty_like(batch.values)
    vals[to_v] = batch.values
    syn = np.empty_like(batch.syndromes)
    syn[to_c] = batch.syndromes
    return vals, syn


def unpack(res, n_vars: int):
    """Packed words [n, n_words] -> bits [n, n_vars]."""
    return np.unpackbits(res.view(np.uint8), bitorder="little",
                         axis=1)[:, :n_vars]


def same_frames(dec_a, dec_i, to_v, to_c, batch, n_frames: int) -> dict:
    """The aligned batch through ``dec_a`` and, renumbered, through
    ``dec_i`` (``decode()``, host arrays; a warm decode each first): the
    words mapped back and the per-frame iterations must be equal. Returns
    both decodes' rates, FER and iterations."""
    dyn, _ = dynamic_params(dec_a, n_frames)
    n = batch.values.shape[1]
    vals_i, syn_i = renumbered(batch, to_v, to_c)
    out = {}
    runs = {}
    for label, dec, v, s in (("aligned", dec_a, batch.values,
                              batch.syndromes),
                             ("interleaved", dec_i, vals_i, syn_i)):
        dec.decode(dyn, n, v, s)
        runs[label] = dec.decode(dyn, n, v, s)
    (res_a, st_a), (res_i, st_i) = runs["aligned"], runs["interleaved"]
    n_vars = dec_a.code.n_vars
    if not np.array_equal(unpack(res_i, n_vars)[:, to_v],
                          unpack(res_a, n_vars)):
        raise AssertionError("interleaved words differ from the aligned")
    if not np.array_equal(st_i.iterations, st_a.iterations):
        raise AssertionError("interleaved per-frame iterations differ")
    errors = np.bitwise_count(batch.ref_bits_packed() ^ res_a).sum(axis=1)
    for label, (dec, st) in (("aligned", (dec_a, st_a)),
                             ("interleaved", (dec_i, st_i))):
        dec_mbps, e2e_mbps = rates(dec, st, n)
        out[label] = {"dec_mbps": dec_mbps, "e2e_mbps": e2e_mbps,
                      "avg_iters": st.avg_iter, "max_iters": st.max_iter,
                      "tables": type(dec.tables).__name__}
    out.update(frames=n, fer1=float((errors > 0).mean()),
               ber=float(errors.sum()) / (n_vars * n),
               iterations=np.asarray(st_a.iterations))
    return out


def run(code, s, sigma: float = 0.87, frames: int = 512, device="cuda",
        log=print, batch=None) -> dict:
    """The benchmark on ``code`` (aligned, structure ``s``): both rates
    from pools on the device and their ratio, then the same frames through
    both (``batch``: the aligned code's host batch, else ``frames`` frames
    of the host datagen at ``sigma``). Returns the record."""
    import torch

    from ldpc_decoder_tpu_torch.codes.qc import interleave_code_numbering
    from ldpc_decoder_tpu_torch.probes._common import card
    from ldpc_decoder_tpu_torch.runtime.datagen import create_data

    info = card(torch.device(device))
    smi = f"{info['name']}, {info['power_limit']}"
    log(f"aligned control (n={code.n_vars}, Z={s.Z}, sigma={sigma}):")
    dec_a = make_decoder(code, s, sigma, device)
    a = run_point(dec_a, frames, "aligned", log)
    t0 = time.perf_counter()
    icode, to_v, to_c = interleave_code_numbering(code, s.Z)
    renumber_s = time.perf_counter() - t0
    log(f"interleaved copy (renumbered in {renumber_s:.1f}s; the plain "
        f"detector fails, the permuted one must recover it):")
    dec_i = make_decoder(icode, None, sigma, device)
    if dec_i.qc is None or dec_i.qc.Z != s.Z:
        raise AssertionError("permuted detection did not recover the lift")
    log(f"  detected Z={dec_i.qc.Z} in {dec_i.detect_seconds:.1f}s "
        f"({type(dec_i.tables).__name__})")
    i = run_point(dec_i, frames, "interleaved", log)
    ratio = i["dec_mbps"] / a["dec_mbps"]
    log(f"aligned {a['dec_mbps']:.1f} Mb/s (FER {a['fer1']:.4f}) vs "
        f"interleaved {i['dec_mbps']:.1f} Mb/s (FER {i['fer1']:.4f}) — "
        f"ratio {ratio:.3f}; {smi}")
    if batch is None:
        t0 = time.perf_counter()
        _, n = dynamic_params(dec_a, frames)
        batch = create_data(code, dec_a.channel, 0, n)
        log(f"host datagen: {n} frames in {time.perf_counter() - t0:.1f}s")
    same = same_frames(dec_a, dec_i, to_v, to_c, batch, frames)
    sa, si = same["aligned"], same["interleaved"]
    log(f"same {same['frames']} frames: interleaved == aligned words and "
        f"per-frame iterations (FER {same['fer1']:.4f}, avg iterations "
        f"{sa['avg_iters']:.2f}); decoding aligned {sa['dec_mbps']:.1f} "
        f"Mb/s vs interleaved {si['dec_mbps']:.1f} Mb/s — ratio "
        f"{si['dec_mbps'] / sa['dec_mbps']:.3f}; {smi}")
    return {"aligned": a, "interleaved": i, "ratio": ratio,
            "same_frames": same, "detect_s": dec_i.detect_seconds,
            "renumber_s": renumber_s, "tables": type(dec_i.tables).__name__,
            "card": info}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("sigma", nargs="?", type=float, default=0.87)
    p.add_argument("frames", nargs="?", type=int, default=512)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device: --device cpu runs the plain versions",
              file=sys.stderr)
        return 1
    from ldpc_decoder_tpu_torch.codes.samples import get_reg36_code

    code, s, _ = get_reg36_code()
    run(code, s, args.sigma, args.frames, args.device,
        log=lambda m: print(m, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
