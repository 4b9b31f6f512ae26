"""What every traffic mix shares: the bank of frames made from the seed,
the measured window's record, the answers of the sampled frames, and
their judgement by the reference.

A mix (``traffic/<name>.json``, parameters only) names in ``"entry"`` the
entry of the program that its window drives, a module
``entries/<entry>.py`` with ``make_bank``, ``warm_up`` and ``window``
(today ``pool``: pools on the card through ``decode_presorted``, and
``stream``: frames from host memory through ``decode_streamed``), and
gives that module's sizes. Each entry's window starts at the first
hand-over and ends when the last result is ready; it ends at the first
call or chunk boundary after ``seconds``, and never before every frame of
the bank was decoded once, so that every sampled frame has an answer.
With ``--trace 1`` the profiler records the calls or chunks
``trace_from`` to ``trace_from + trace_count - 1``.

The sampled frames (``sample_frames`` of the bank, drawn from the seed)
are checked in every call or chunk that decodes them: each answer's words
against the first answer's (at once) and, after the window, the first
answer's words and every answer's iteration count against the plain
reference's.
"""

from __future__ import annotations

import time
from contextlib import nullcontext
from dataclasses import dataclass, field

import numpy as np
import torch

from pbcore import bank
from pbcore.trace import Trace, from_profiler


def span(name: str, on: bool):
    return torch.profiler.record_function(name) if on else nullcontext()


class Answers:
    """The answers due for the sampled frames of a bank cut into groups
    (pools or chunks) of ``group_frames``."""

    def __init__(self, sample: np.ndarray, group_frames: int, device):
        self.sample = sample
        self.n = np.zeros(sample.size, np.int64)          # answers
        self.count_sum = np.zeros(sample.size, np.int64)  # their counts
        self.repeats = torch.zeros(sample.size, dtype=torch.int64,
                                   device=device)  # words unlike the first
        self.first: dict[int, torch.Tensor] = {}
        self.rows: dict[int, tuple] = {}
        groups = sample // group_frames
        for g in np.unique(groups):
            pos = np.nonzero(groups == g)[0]
            local = sample[pos] - g * group_frames
            self.rows[int(g)] = (local, torch.from_numpy(local).to(device),
                                 torch.from_numpy(pos).to(device), pos)

    def add(self, group: int, words: torch.Tensor, iterations: np.ndarray):
        """One call's or chunk's answers: ``words`` [n, n_words] int32,
        ``iterations`` [n]."""
        if group not in self.rows:
            return
        local, local_t, pos_t, pos = self.rows[group]
        got = words.index_select(0, local_t.to(words.device))
        if group not in self.first:
            self.first[group] = got.clone()
        else:
            self.repeats.index_add_(0, pos_t, (got != self.first[group]).any(
                1).to(torch.int64).to(self.repeats.device))
        self.n[pos] += 1
        self.count_sum[pos] += iterations[local]

    def first_words(self, n_words: int) -> np.ndarray:
        """[sample, n_words] uint32: each frame's first answer (zeros where
        none came)."""
        out = np.zeros((self.sample.size, n_words), np.uint32)
        for g, words in self.first.items():
            out[self.rows[g][3]] = words.cpu().numpy().view(np.uint32)
        return out


@dataclass
class Window:
    seconds: float                      # first hand-over to last result
    calls: int                          # calls or chunks
    frames: int
    stats: list                         # DecodeStats of each call or chunk
    latencies: list = field(default_factory=list)  # s, per chunk
    upload_ms: list = field(default_factory=list)
    compute_gap_ms: list = field(default_factory=list)
    trace: Trace | None = None
    traced_calls: int = 0


class Profiler:
    """``torch.profiler`` over one stretch of the window, by the host
    clock; nothing when the run is not traced."""

    def __init__(self, on: bool):
        self.on, self.prof, self.t0, self.trace = on, None, 0.0, None

    def start(self):
        if self.on and self.prof is None and self.trace is None:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.__enter__()
            self.t0 = time.perf_counter()

    def stop(self):
        if self.prof is not None:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            window = time.perf_counter() - self.t0
            self.prof.__exit__(None, None, None)
            self.trace = from_profiler(self.prof, window)
            self.prof = None

    @property
    def pending(self) -> bool:
        return self.on and self.trace is None


# ---- set-up ---------------------------------------------------------------

@dataclass
class Bank:
    groups: list          # what the window hands over, one per call or chunk
    group_frames: int
    sample: np.ndarray    # bank frame ids
    sample_values: torch.Tensor    # [n_vars, sample] float32, host
    sample_syndromes: torch.Tensor  # [n_checks, sample] int8, host
    answers_device: object  # where the sampled answers are compared


def make_bank(graph, buckets, cfg: dict, mix: dict, seed: int, device,
              group_frames: int, stage, answers_device) -> Bank:
    """The mix's bank of ``bank_frames`` frames from ``seed``, made on
    ``device`` in blocks of ``group_frames``; ``stage(values, syndromes)``
    turns each block into what the window hands over (it may reuse its
    arguments' memory only until it returns)."""
    n_groups = mix["bank_frames"] // group_frames
    sample = bank.sample_frames(seed, n_groups * group_frames,
                                mix["sample_frames"])
    gen = bank.generator(seed, device)
    groups, kept_v, kept_s = [], [], []
    for g in range(n_groups):
        v, s = bank.make_block(graph, buckets, cfg["channel"], cfg["noise"],
                               group_frames, gen, device)
        local = torch.from_numpy(
            sample[(sample >= g * group_frames)
                   & (sample < (g + 1) * group_frames)]
            - g * group_frames).to(device)
        kept_v.append(v.index_select(1, local).cpu())
        kept_s.append(s.index_select(1, local).cpu())
        groups.append(stage(v, s))
        del v, s
    return Bank(groups, group_frames, sample, torch.cat(kept_v, 1),
                torch.cat(kept_s, 1), answers_device)


# ---- the judgement ----------------------------------------------------------

def unpack(words: torch.Tensor, n_vars: int) -> torch.Tensor:
    """[F, n_words] int32 words -> [n_vars, F] 0/1 int8 bits."""
    shifts = torch.arange(32, device=words.device, dtype=torch.int32)
    bits = (words[:, :, None] >> shifts) & 1
    return bits.reshape(words.shape[0], -1)[:, :n_vars].T.to(torch.int8)


def judge(reference, buckets, b: Bank, answers: Answers, cfg: dict,
          B: int, device) -> dict:
    """The numbers compared, each with its limit: ``wrong_words`` (answers
    whose words differ from the reference's, on frames the reference
    decodes; on a frame it cannot decode, an answer that claims a success,
    a count under the cap, with words that violate the frame's syndrome),
    ``missing`` (sampled frames with no answer), ``abs_iter_gap`` (the
    size of the mean, over the answers, of the program's iteration count
    minus the reference's). A number passes at or under its limit."""
    first_fill = torch.from_numpy(b.sample % b.group_frames < B)
    ref_words, ref_counts, ref_solved = [], [], []
    block = reference.BLOCK_FRAMES
    for a in range(0, b.sample.size, block):
        sl = slice(a, a + block)
        words, counts, solved = reference.decode(
            buckets, b.sample_values[:, sl].to(device),
            b.sample_syndromes[:, sl].to(device),
            first_fill[sl].to(device), cfg)
        ref_words.append(words.cpu().numpy().view(np.uint32))
        ref_counts.append(counts.cpu().numpy())
        ref_solved.append(solved.cpu().numpy())
    ref_words = np.concatenate(ref_words)
    ref_counts = np.concatenate(ref_counts)
    ref_solved = np.concatenate(ref_solved)
    first = answers.first_words(ref_words.shape[1])
    repeats = answers.repeats.cpu().numpy()
    first_wrong = (first != ref_words).any(1)
    unsolved = np.nonzero(~ref_solved & (answers.n > 0))[0]
    if unsolved.size:  # judged by what the program's answer claims
        bits = unpack(torch.from_numpy(first[unsolved].view(np.int32)).to(
            device), cfg["n_vars"])
        violates = (buckets.syndromes(bits).cpu()
                    != b.sample_syndromes[:, unsolved]).any(0).numpy()
        mean_count = answers.count_sum[unsolved] / answers.n[unsolved]
        first_wrong[unsolved] = violates & (mean_count
                                            < cfg["max_iterations"])
    wrong = np.where(first_wrong, answers.n - repeats, repeats)
    n = int(answers.n.sum())
    gap = float((answers.count_sum - answers.n * ref_counts).sum() / n) \
        if n else float("inf")
    lim = cfg["limits"]
    return {
        "wrong_words": {"value": int(wrong.sum()), "limit": 0},
        "missing": {"value": int((answers.n == 0).sum()), "limit": 0},
        "abs_iter_gap": {"value": abs(gap), "limit": lim["abs_iter_gap"]},
        "_answers": n,
        "_iter_gap_signed": gap,
        "_ref_mean_count": float(ref_counts.mean()),
        "_ref_unsolved": int(unsolved.size),
    }


def passed(checks: dict) -> bool:
    return (checks["wrong_words"]["value"] <= 0
            and checks["missing"]["value"] <= 0
            and checks["abs_iter_gap"]["value"]
            <= checks["abs_iter_gap"]["limit"])
