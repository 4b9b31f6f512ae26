"""Error-rate qualification of a code on the PyTorch/CUDA port.

The port's counterpart of ``scripts/fer_stats.py``, with its protocol and
its JSON keys: FRAMES (default 2048) frames per noise point, generated on
the decoder's device from absolute frame indices (so they are the JAX
script's frames), decoded in pools of 2B frames with B = 256 lanes of
bfloat16 sum-product messages, k = 14, at most 120 iterations, loading
factor 2; per point FER(>0), FER(>15), BER, exact event counts, average and
maximum iterations, the steady-state decoding throughput
n / (avg_iter · itpv · 2^20) (``test_report.cpp:133``), and, beside them,
the seconds the pools took to generate (``datagen_s``); on the card the
record also names the card and its power limit (``card``).

    [FRAMES=2048] [SIGMAS=0.94,0.95] [CHANNEL=0] [FIRST_CHECK=auto]
    [FER_ALIST=path] [FER_OUT=path] python scripts/fer_stats_torch.py
    [--device cpu]

CHANNEL: 0 BI-AWGN (SIGMAS are sigma), 1 BSC (flip probabilities p), 2
erasure (epsilon). FIRST_CHECK "auto" delays the first parity check to
iteration 70 on BI-AWGN at sigma >= 0.94 (bench.py's rule for p41) and
checks from the start otherwise. FER_ALIST qualifies another code (an alist
with or without a QC header) instead of p41 (``codes/samples.py``). The
record goes to FER_OUT, by default ``scripts/out/fer_stats_torch.json`` in
the checkout. It runs on the card; ``--device cpu`` (or FER_DEVICE=cpu)
runs the plain PyTorch versions on the CPU, with the lane count taken from
a 1 GiB memory model (for small codes: tests).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

MAX_ITER = 120
CPU_MEMORY_BYTES = 1 << 30


def first_check_for(channel_idx: int, x: float, rule: str = "auto") -> int:
    """The delayed first parity check: "auto" gives 70 on BI-AWGN at
    sigma >= 0.94 (the p41 burst qualified by bench.py), else 0; any other
    value is the iteration itself."""
    if rule == "auto":
        return 70 if channel_idx == 0 and x >= 0.94 else 0
    return int(rule)


def qualification_decoder(code, qc, channel_idx: int, x: float, device,
                          message_dtype: str = "bfloat16"):
    """(the protocol's decoder, its channel) at noise ``x``: B <= 256 lanes
    of sum-product messages on ``device``, bfloat16 as the JAX script's
    unless ``message_dtype`` names another (``"float8_e5m2"``: the
    callers that record it beside bfloat16; the script has no option)."""
    import torch

    from ldpc_decoder_tpu_torch.channels import (
        BIAWGNChannel,
        BSCChannel,
        ErasureChannel,
    )
    from ldpc_decoder_tpu_torch.runtime.decoder import LDPCDecoder
    from ldpc_decoder_tpu_torch.runtime.params import StaticParams

    ch = {0: BIAWGNChannel, 1: BSCChannel, 2: ErasureChannel}[channel_idx](x)
    device = torch.device(device)
    memory = CPU_MEMORY_BYTES if device.type == "cpu" else None
    dec = LDPCDecoder(code, ch, StaticParams(
        max_log_parallel_factor_user=8, message_dtype=message_dtype,
        device_memory_bytes=memory), qc=qc, device=device)
    return dec, ch


def pool_frames(dec) -> int:
    """Frames of one pool, each generated as one chunk: 2B."""
    return 2 * dec.parallel_factor()


def qualify_point(code, qc, channel_idx: int, x: float, frames: int,
                  first_check: int, device, log=print,
                  message_dtype: str = "bfloat16") -> dict:
    """Decode ``frames`` frames (frames 0 .. frames, pools of 2B) at noise
    ``x`` and return the point's record; ``message_dtype`` as in
    :func:`qualification_decoder`."""
    import torch

    from ldpc_decoder_tpu_torch.runtime.datagen_device import (
        count_bit_errors,
        create_pool_device,
    )
    from ldpc_decoder_tpu_torch.runtime.params import DynamicParams

    device = torch.device(device)
    dec, ch = qualification_decoder(code, qc, channel_idx, x, device,
                                    message_dtype)
    dyn = DynamicParams(num_iter_max=MAX_ITER, num_iter_check_parity=14,
                        num_iter_first_check=first_check, loading_factor=2)
    errs, iters, itpvs = [], [], []
    datagen_s = 0.0
    t_pt = time.perf_counter()
    step = pool_frames(dec)
    for lo in range(0, frames, step):
        n = min(step, frames - lo)
        t0 = time.perf_counter()
        pool = create_pool_device(dec, ch, lo, n, chunk_frames=n)
        # the pool must be ready before the decode clock starts, or the
        # decode's elapsed absorbs the datagen still queued on the device
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        datagen_s += time.perf_counter() - t0
        results, stats = dec.decode_presorted(
            dyn, n, pool.values_sorted, pool.syn_sorted, fetch_results=False)
        errs.append(count_bit_errors(results, pool.ref_packed).cpu().numpy())
        iters.append(stats.iterations)
        itpvs.append(stats.iter_time_per_vector)
        del pool, results
    errors, iters = np.concatenate(errs), np.concatenate(iters)
    # the first pool's itpv may carry first-use costs: averaged over the
    # others when there are others, as the JAX script does
    itpv = float(np.mean(itpvs[1:] if len(itpvs) > 1 else itpvs))
    pt = {
        "sigma": x,
        "frames": int(errors.size),
        "fer1": float((errors > 0).mean()),
        "fer1_events": int((errors > 0).sum()),
        "fer15": float((errors > 15).mean()),
        "fer15_events": int((errors > 15).sum()),
        "ber": float(errors.sum()) / (code.n_vars * errors.size),
        "bit_errors": int(errors.sum()),
        "avg_iters": round(float(iters.mean()), 2),
        "max_iters": int(iters.max()),
        "itpv": itpv,
        "dec_mbps": round(code.n_vars / (float(iters.mean()) * itpv
                                         * 1048576.0), 1),
        "first_check": first_check,
        "datagen_s": datagen_s,
    }
    log(f"x={x}: frames={pt['frames']} FER(>0)={pt['fer1']:.5f} "
        f"({pt['fer1_events']} events) FER(>15)={pt['fer15']:.5f} "
        f"BER={pt['ber']:.3e} avg_iters={pt['avg_iters']} max_iters="
        f"{pt['max_iters']} {pt['dec_mbps']} Mb/s datagen "
        f"{datagen_s:.3f} s [{time.perf_counter() - t_pt:.1f} s]")
    return pt


def run(code, qc, channel_idx: int, xs, frames: int = 2048,
        first_check: str = "auto", device="cuda", log=print) -> dict:
    """The record of every point of ``xs`` (``fer_stats.py``'s keys)."""
    if frames < 32 or frames % 32:
        raise ValueError(f"FRAMES must be a positive multiple of 32, got "
                         f"{frames}")
    out = {"n_vars": code.n_vars, "n_erased": code.n_erased_vars,
           "max_iter": MAX_ITER, "channel": channel_idx, "points": []}
    for x in xs:
        fc = first_check_for(channel_idx, x, first_check)
        out["points"].append(qualify_point(code, qc, channel_idx, x, frames,
                                           fc, device, log))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", choices=["cuda", "cpu"],
                   default=os.environ.get("FER_DEVICE", "cuda"))
    args = p.parse_args(argv)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device: --device cpu runs the plain versions",
              file=sys.stderr)
        return 1
    frames = int(os.environ.get("FRAMES", "2048"))
    xs = [float(s) for s in os.environ.get("SIGMAS", "0.94,0.95").split(",")]
    channel_idx = int(os.environ.get("CHANNEL", "0"))
    alist = os.environ.get("FER_ALIST")
    if alist:
        from ldpc_decoder_tpu_torch.codes.qc import load_qc_alist

        code, qc = load_qc_alist(alist)
        print(f"candidate code: {alist}", flush=True)
    else:
        from ldpc_decoder_tpu_torch.codes.samples import get_code

        code, qc, _ = get_code()
    out = run(code, qc, channel_idx, xs, frames,
              os.environ.get("FIRST_CHECK", "auto"), args.device,
              log=lambda m: print(m, flush=True))
    out["device"] = (torch.cuda.get_device_name(0) if args.device == "cuda"
                     else "cpu")
    if args.device == "cuda":  # the name and power limit beside the rates
        from ldpc_decoder_tpu_torch.probes._common import card

        out["card"] = card(torch.device("cuda", 0))
    path = os.environ.get("FER_OUT", os.path.join(
        REPO, "scripts", "out", "fer_stats_torch.json"))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
