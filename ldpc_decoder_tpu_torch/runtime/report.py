"""Test reporting: BER/FER/iteration/throughput summary.

Field-for-field, formula-for-formula mirror of the reference's test_report
(h/test_report.h:13-53, src/test_report.cpp:5-135), so runs can be compared
side by side with the reference's README output (README.md:70-107).

JAX-free copy of ``ldpc_decoder_tpu/runtime/report.py`` (numpy only), held
equal to it by ``tests/test_torch_cli.py``: same strings, same formulas.
"""

from __future__ import annotations

import io
from dataclasses import dataclass, field

import numpy as np

from ldpc_decoder_tpu_torch.channels.base import Channel
from ldpc_decoder_tpu_torch.codes.code import LDPCCode, rate


def describe_channel(channel: Channel) -> str:
    # test_report.cpp:77-84
    return (
        "Channel:\n"
        f"{channel.description()}\n"
        f"capacity: {channel.capacity():g} bits/symbol\n\n"
    )


def describe_code(code: LDPCCode) -> str:
    # test_report.cpp:63-75
    return (
        "Error-correcting code:\n"
        f"{code.n_vars} variables\n"
        f"{code.n_checks} parity bits\n"
        f"{code.n_erased_vars} erased variables (not sent, but recovered)\n"
        f"maximum input bit arity: {code.max_degree_in}\n"
        f"maximum output/check bit arity: {code.max_degree_out}\n"
        f"Rate = {rate(code):g}\n\n"
    )


def describe_code_and_channel(code: LDPCCode, channel: Channel) -> str:
    # test_report.cpp:47-61
    eff = rate(code) / channel.capacity() * 100.0
    return (
        describe_channel(channel)
        + describe_code(code)
        + f"Code efficiency over channel = rate/channel capacity = "
        f"{eff:.2f}%\n"
    )


def describe_error_stats(
    n_frames: int, offset: int, errors: np.ndarray, frame_size: int,
    log_level: int = 1,
) -> str:
    # test_report.cpp:5-45
    out = io.StringIO()
    if n_frames > 1:
        total = float(errors.sum())
        out.write(
            f"on vectors {offset} ... {offset + n_frames - 1}:\n"
            f"  total = {total:g}, average = {total / n_frames:g}, "
            f"min = {int(errors.min())}, max = {int(errors.max())}\n"
        )
        if log_level >= 3:
            for v in range(n_frames):
                out.write(
                    f"errors on vector {v}: {int(errors[v])}; p = "
                    f"{errors[v] / frame_size:g}\n"
                )
    else:
        out.write(f"on frame {offset}: {int(errors[0])}\n")
    return out.getvalue()


@dataclass
class TestReport:
    """Aggregates one test's statistics (h/test_report.h:13-53)."""

    code_and_channel_specs: str = ""
    num_vectors_per_run: int = 0
    num_runs: int = 0
    frame_size: int = 0
    target_errors: int = 0

    ber: float = 0.0
    avg_iter: float = 0.0
    iter_time_per_vector: float = 0.0
    min_iter: int = 2**32 - 1
    max_iter: int = 0
    elapsed_time: float = 0.0
    mbits_processed: float = 0.0
    vectors_with_errors: int = 0
    max_bit_error: int = 0
    num_bit_errors: int = 0
    vectors_with_error_above_target: int = 0
    report: str = field(default="", repr=False)

    def gen_summary(self) -> str:
        # test_report.cpp:96-135
        out = io.StringIO()
        out.write(" " * 44 + "***\n")
        out.write(" " * 42 + "Summary \n\n")
        out.write("* Channel and code description\n\n")
        out.write(self.code_and_channel_specs)
        out.write("\n\n")
        out.write("* Test result\n\n")

        bits_processed = (
            self.num_runs * self.frame_size * self.num_vectors_per_run
        )
        self.ber = (
            self.num_bit_errors / bits_processed if bits_processed else 0.0
        )
        self.mbits_processed = float(bits_processed >> 20)
        frames_decoded = self.num_runs * self.num_vectors_per_run

        w = out.write
        w(f"# of frames decoded:              {frames_decoded}\n")
        w(f"Frame size:                       {self.frame_size} bits\n")
        w(f"Total # of errors:                {self.num_bit_errors}\n")
        w(f"Bit error rate (BER):             {self.ber:g}\n")
        w(f"Maximum # of errors / frame:      {self.max_bit_error}\n")
        if self.target_errors > 0:
            fer_t = (
                self.vectors_with_error_above_target / frames_decoded
                if frames_decoded else 0.0
            )
            w(
                f"Frames with more than {self.target_errors} errors:  "
                f"{self.vectors_with_error_above_target} "
                f"(corresponding FER: {fer_t:g})\n"
            )
        fer = (
            self.vectors_with_errors / frames_decoded if frames_decoded
            else 0.0
        )
        w(
            f"Frames with at least one error:   {self.vectors_with_errors} "
            f"(corresponding FER: {fer:g})\n"
        )
        w("\n")
        w(f"Mbits processed:                  {self.mbits_processed:g}\n")
        w(f"Elapsed system time:              {self.elapsed_time:g} sec.\n")
        thr = (
            self.mbits_processed / self.elapsed_time
            if self.elapsed_time else 0.0
        )
        w(
            f"Throughput including transfers and finish: {thr:g} "
            f"Mbits/sec.\n"
        )
        w(
            f"Max/min/average number of iterations per vector: "
            f"{self.max_iter}/{self.min_iter}/{self.avg_iter:g}\n"
        )
        w(
            f"Iteration time per vector (i.e. iteration time / vector "
            f"batch size): {self.iter_time_per_vector:g} sec\n"
        )
        dec_thr = (
            self.frame_size
            / (self.avg_iter * self.iter_time_per_vector * 1048576.0)
            if self.avg_iter and self.iter_time_per_vector else 0.0
        )
        w(f"Decoding throughput: {dec_thr:g} Mbits/sec.\n\n")
        self.report = out.getvalue()
        return self.report
