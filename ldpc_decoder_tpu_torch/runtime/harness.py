"""Self-testing harness: generate → decode → count errors → report.

The do_test equivalent (main.cpp:301-448; ``ldpc_decoder_tpu/runtime/
harness.py``, whose printed lines it keeps): runs ``num_runs`` batches of
``parallel_factor × loading_factor`` frames generated on the host,
XOR-popcounts the decoded words against the reference bits, and aggregates
a :class:`~ldpc_decoder_tpu_torch.runtime.report.TestReport`.

At log level 2 and above the first batch is also profiled phase by phase
(:meth:`LDPCDecoder.profile_phases`) on pools laid out in the decoder's
own I/O orders (:meth:`LDPCDecoder.upload_pools`), which stay right for an
interleaved numbering, and every superstep prints the frames remaining.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from ldpc_decoder_tpu_torch.channels.base import Channel
from ldpc_decoder_tpu_torch.codes.code import LDPCCode
from ldpc_decoder_tpu_torch.runtime.datagen import create_data
from ldpc_decoder_tpu_torch.runtime.decoder import LDPCDecoder
from ldpc_decoder_tpu_torch.runtime.params import DynamicParams, StaticParams
from ldpc_decoder_tpu_torch.runtime.report import (
    TestReport,
    describe_code_and_channel,
    describe_error_stats,
)


def do_test(
    code: LDPCCode,
    channel: Channel,
    num_runs: int,
    static_params: StaticParams,
    dyn_params: DynamicParams,
    start_index: int = 0,
    log_level: int = 1,
    out=None,
    decoder: LDPCDecoder | None = None,
) -> TestReport:
    """Run the test; the log goes to ``out`` (default: ``sys.stdout`` as
    it is at the call)."""
    out = out or sys.stdout
    dec = decoder or LDPCDecoder(code, channel, static_params)
    n_vec_per_run = dec.parallel_factor() * dyn_params.loading_factor
    frame_size = code.n_vars

    report = TestReport(
        code_and_channel_specs=describe_code_and_channel(code, channel),
        num_runs=num_runs,
        num_vectors_per_run=n_vec_per_run,
        frame_size=frame_size,
        target_errors=dyn_params.target_errors,
    )

    out.write(
        f"Performing a test with {num_runs} run(s)\n"
        f"Number of vectors (or frames) per run: {n_vec_per_run}\n\n"
    )
    out.write(
        f"Total syndrome size per batch: "
        f"{code.n_effective_outputs * n_vec_per_run} bits\n"
    )
    out.write(
        f"Total data size per batch: {frame_size * n_vec_per_run} bits\n\n"
    )

    for i in range(num_runs):
        out.write(f"Creating and processing frame batch {i} / {num_runs}\n")
        out.write(" Creating test vectors\n")
        t0 = time.perf_counter()
        batch = create_data(code, channel, start_index, n_vec_per_run, i)
        out.write(
            f" Test vector computation time: {time.perf_counter() - t0:g}\n"
        )
        offset = start_index + n_vec_per_run * i

        if log_level >= 3:
            pre_bits = (batch.values > 0).astype(np.int8)
            pre_errors = (pre_bits != batch.ref_bits).sum(axis=0)
            out.write(" Computing errors before EC\n")
            out.write("  Errors before error correction ")
            out.write(
                describe_error_stats(
                    n_vec_per_run, offset, pre_errors, frame_size, log_level
                )
            )

        out.write(" Decoding\n")
        if log_level >= 2 and i == 0:
            # per-phase step timing, the print_time analog
            # (ldpc_decoder_gpu.cu:275-281, 517-601)
            pool_values, pool_syn = dec.upload_pools(batch.values,
                                                     batch.syndromes)
            phases = dec.profile_phases(pool_values, pool_syn, dyn_params,
                                        n_vec_per_run)
            del pool_values, pool_syn
            out.write(" Phase timings (per call):\n")
            for name, secs in phases.items():
                out.write(f"  {name:22s} {secs * 1e3:9.3f} ms\n")
        # log level >= 2: per-superstep convergence progress (the
        # reference's per-iteration convergence counts at -l >= 2,
        # ldpc_decoder_gpu.cu:391-412)
        progress = (
            (lambda rem: out.write(f"  frames remaining: {rem}\n"))
            if log_level >= 2 else None
        )
        results, stats = dec.decode(
            dyn_params, n_vec_per_run, batch.values, batch.syndromes,
            host_poll=log_level >= 2, progress=progress,
        )
        report.elapsed_time += stats.elapsed_seconds

        if log_level >= 1:
            out.write(
                f"Iterations (avg / max / min): {stats.avg_iter:g} "
                f"{stats.max_iter} {stats.min_iter}\n"
            )

        out.write(" Computing errors after EC\n")
        ref_packed = batch.ref_bits_packed()
        errors = np.bitwise_count(ref_packed ^ results).sum(
            axis=1, dtype=np.int64
        )

        out.write("  Errors after error correction ")
        out.write(
            describe_error_stats(
                n_vec_per_run, offset, errors, frame_size, log_level
            )
        )

        report.num_bit_errors += int(errors.sum())
        report.vectors_with_errors += int((errors > 0).sum())
        report.vectors_with_error_above_target += int(
            (errors > dyn_params.target_errors).sum()
        )
        report.max_bit_error = max(report.max_bit_error, int(errors.max()))
        report.min_iter = min(report.min_iter, stats.min_iter)
        report.max_iter = max(report.max_iter, stats.max_iter)
        # aggregate mean across runs
        report.avg_iter += stats.avg_iter / num_runs
        report.iter_time_per_vector += stats.iter_time_per_vector / num_runs
        out.write("\n")

    out.write("End of decoding test\n\n")
    report.gen_summary()
    return report
