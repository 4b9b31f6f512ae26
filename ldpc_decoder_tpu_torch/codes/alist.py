"""alist parsing/writing for LDPC parity-check graphs.

JAX-free copy of ``ldpc_decoder_tpu/codes/alist.py``, held equal to it by
``tests/test_torch_host.py``.

The file format follows the convention of the reference decoder
(``kunzjacq/ldpc_decoder`` — see src/ldpc_code.cpp:45-152):

- Optional leading comment-header lines ``#name=value``. Recognized names:
  ``e`` (number of erased/punctured variables — not transmitted but decoded)
  and ``ec`` (number of erased check bits). Unknown names are ignored.
- First data line: ``n_checks n_vars`` (*checks first* — note this is the
  transpose of the MacKay alist header; we follow the reference's reader).
- Second line: max degrees (ignored; recomputed from the degree lists).
- Then ``n_checks`` integers: per-check degrees.
- Then ``n_vars`` integers: per-variable degrees.
- Then ``n_checks`` rows, one per line: the 1-based variable indices adjacent
  to that check. Rows may be zero-padded to the max degree (the padding is
  dropped, mirroring the reference's read-then-skip-to-EOL behaviour,
  ldpc_code.cpp:139-151). Any trailing blocks (e.g. MacKay-style per-variable
  adjacency lists) are ignored.

Edge numbering convention (identical to the reference, ldpc_code.cpp:119-151):

- *check-side* ("out") edge ``j``: edges enumerated check-major, in file order.
- *variable-side* ("in") edge ``i``: edges enumerated variable-major; within a
  variable, in order of appearance in the file (i.e. by increasing check-side
  edge index). Consequently ``edge_in_to_out = stable-argsort of the flat
  column-index array`` — the whole table construction is vectorized here
  instead of the reference's scalar occurrence-counting loop.
"""

from __future__ import annotations

import io
from dataclasses import dataclass

import numpy as np


@dataclass
class AlistData:
    """Raw contents of an alist file."""

    n_checks: int
    n_vars: int
    check_degrees: np.ndarray  # [n_checks] int32
    var_degrees: np.ndarray  # [n_vars] int32
    # flat, check-major list of 0-based variable indices; length = n_edges
    check_adjacency: np.ndarray  # [n_edges] int32
    n_erased_vars: int = 0
    n_erased_checks: int = 0


def _parse_headers(lines: list[str]) -> tuple[int, int, int]:
    """Parse leading '#k=v' lines; returns (first_data_line, e, ec)."""
    e = 0
    ec = 0
    i = 0
    while i < len(lines) and lines[i].lstrip().startswith("#"):
        token = lines[i].lstrip()[1:].split()[0] if lines[i].lstrip()[1:].split() else ""
        if "=" in token:
            name, _, value = token.partition("=")
            if name == "e":
                e = int(value)
            elif name == "ec":
                ec = int(value)
        i += 1
    return i, e, ec


def parse_alist(text_or_path: str) -> AlistData:
    """Parse an alist from a file path or from literal text content."""
    if "\n" not in text_or_path:
        with open(text_or_path, "r") as f:
            text = f.read()
    else:
        text = text_or_path
    lines = text.splitlines()
    start, n_erased_vars, n_erased_checks = _parse_headers(lines)
    lines = lines[start:]
    if len(lines) < 4:
        raise ValueError("malformed alist: too few lines")

    first = lines[0].split()
    n_checks, n_vars = int(first[0]), int(first[1])
    # lines[1] holds the max degrees; recomputed below.

    body = lines[2:]

    # Degree sections: consume tokens across lines until each count is met;
    # the remainder of the line where a section completes is discarded.
    def take_tokens(line_idx: int, count: int) -> tuple[np.ndarray, int]:
        out: list[str] = []
        while len(out) < count:
            if line_idx >= len(body):
                raise ValueError("malformed alist: truncated degree section")
            toks = body[line_idx].split()
            line_idx += 1
            need = count - len(out)
            out.extend(toks[:need])
        return np.array(out, dtype=np.int32), line_idx

    check_degrees, li = take_tokens(0, n_checks)
    var_degrees, li = take_tokens(li, n_vars)
    if int(check_degrees.sum()) != int(var_degrees.sum()):
        raise ValueError(
            "malformed alist: check/variable degree sums disagree "
            f"({int(check_degrees.sum())} vs {int(var_degrees.sum())})"
        )
    n_edges = int(check_degrees.sum())

    # Adjacency rows. Fast path: the rest of the body tokenizes to exactly
    # n_edges integers (our writer's output). Otherwise parse row-per-line,
    # dropping zero padding.
    rest = "\n".join(body[li:])
    tokens = rest.split()
    if len(tokens) == n_edges:
        adjacency = np.array(tokens, dtype=np.int64)
        if (adjacency <= 0).any() or (adjacency > n_vars).any():
            raise ValueError("malformed alist: adjacency index out of range")
        adjacency = (adjacency - 1).astype(np.int32)
    else:
        rows: list[np.ndarray] = []
        row_idx = 0
        for line in body[li:]:
            if row_idx >= n_checks:
                break
            toks = line.split()
            if not toks:
                continue
            deg = int(check_degrees[row_idx])
            if len(toks) < deg:
                raise ValueError(
                    f"malformed alist: check row {row_idx} has {len(toks)} "
                    f"entries, expected at least {deg}"
                )
            row = np.array(toks[:deg], dtype=np.int64)
            if (row <= 0).any() or (row > n_vars).any():
                raise ValueError("malformed alist: adjacency index out of range")
            rows.append((row - 1).astype(np.int32))
            row_idx += 1
        if row_idx != n_checks:
            raise ValueError("malformed alist: missing check adjacency rows")
        adjacency = (
            np.concatenate(rows) if rows else np.zeros((0,), dtype=np.int32)
        )

    # Validate per-variable degrees against the adjacency.
    counts = np.bincount(adjacency, minlength=n_vars).astype(np.int32)
    if not np.array_equal(counts, var_degrees):
        raise ValueError("malformed alist: variable degrees disagree with adjacency")

    return AlistData(
        n_checks=n_checks,
        n_vars=n_vars,
        check_degrees=check_degrees,
        var_degrees=var_degrees,
        check_adjacency=adjacency,
        n_erased_vars=n_erased_vars,
        n_erased_checks=n_erased_checks,
    )


def write_alist(data: AlistData, path: str | None = None) -> str:
    """Serialize to the reference's alist format (no zero padding)."""
    buf = io.StringIO()
    if data.n_erased_vars:
        buf.write(f"#e={data.n_erased_vars}\n")
    if data.n_erased_checks:
        buf.write(f"#ec={data.n_erased_checks}\n")
    buf.write(f"{data.n_checks} {data.n_vars}\n")
    max_c = int(data.check_degrees.max(initial=0))
    max_v = int(data.var_degrees.max(initial=0))
    buf.write(f"{max_c} {max_v}\n")
    buf.write(" ".join(map(str, data.check_degrees.tolist())) + "\n")
    buf.write(" ".join(map(str, data.var_degrees.tolist())) + "\n")
    offsets = np.concatenate(
        [[0], np.cumsum(data.check_degrees.astype(np.int64))]
    )
    adj1 = (data.check_adjacency.astype(np.int64) + 1).tolist()
    parts = []
    for i in range(data.n_checks):
        parts.append(" ".join(map(str, adj1[offsets[i] : offsets[i + 1]])))
    buf.write("\n".join(parts) + "\n")
    text = buf.getvalue()
    if path is not None:
        with open(path, "w") as f:
            f.write(text)
    return text
