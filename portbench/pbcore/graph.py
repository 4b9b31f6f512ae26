"""The Tanner graph of an alist file, read by the benchmark's own parser.

The benchmark reads the code that the program decodes from the same alist
file, but with this parser and not the program's, so that the syndromes
it hands to the program and the plain reference's decode rest on nothing
the program computed. The format is the reference decoder's (checks
first): optional ``#name=value`` header lines (``#e=`` counts the trailing
punctured variables), ``n_checks n_vars``, the two maximum degrees, the
check degrees, the variable degrees, then one row of 1-based variable
indices per check, possibly zero-padded to the maximum degree. Anything
after the check rows is ignored.

:class:`Buckets` lays the graph out for plain PyTorch on a device: the
edges numbered check-major, as in the file, grouped by check degree and by
variable degree, so that a node update is a gather, a sum over one axis
and a scatter.
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class Graph:
    n_vars: int
    n_checks: int
    n_punctured: int            # trailing variables with no channel value
    check_degrees: np.ndarray   # [n_checks] int64
    var_degrees: np.ndarray     # [n_vars] int64
    adjacency: np.ndarray       # [n_edges] int64, check-major, 0-based

    @property
    def n_edges(self) -> int:
        return int(self.adjacency.size)


def _ints(text: str) -> np.ndarray:
    return np.array(text.split(), dtype=np.int64)


def parse_alist(path: str) -> Graph:
    """The graph of the alist file at ``path``; ValueError when the file
    contradicts itself."""
    with open(path) as f:
        lines = f.read().splitlines()
    punctured, i = 0, 0
    while i < len(lines) and lines[i].lstrip().startswith("#"):
        key, _, value = lines[i].strip()[1:].partition("=")
        if key == "e":
            punctured = int(value)
        i += 1
    n_checks, n_vars = (int(x) for x in lines[i].split()[:2])
    i += 2  # the maximum degrees are recomputed
    degrees, need = [], n_checks + n_vars
    while sum(d.size for d in degrees) < need:
        degrees.append(_ints(lines[i]))
        i += 1
    degrees = np.concatenate(degrees)
    if degrees.size != need:
        raise ValueError(f"{path}: degree lists run into the rows")
    check_deg, var_deg = degrees[:n_checks], degrees[n_checks:]
    n_edges = int(check_deg.sum())
    rows = [r for r in lines[i:] if r.strip()][:n_checks]
    flat = _ints(" ".join(rows))
    if flat.size != n_edges:  # rows padded with zeros to the max degree
        width = flat.size // n_checks
        if width * n_checks != flat.size:
            raise ValueError(f"{path}: ragged check rows")
        flat = flat.reshape(n_checks, width)[
            np.arange(width)[None, :] < check_deg[:, None]]
    if flat.size != n_edges or flat.min() < 1 or flat.max() > n_vars:
        raise ValueError(f"{path}: check rows disagree with the degrees")
    adjacency = flat - 1
    if not np.array_equal(np.bincount(adjacency, minlength=n_vars), var_deg):
        raise ValueError(f"{path}: variable degrees disagree with the rows")
    return Graph(n_vars, n_checks, punctured, check_deg, var_deg, adjacency)


def load_graph(path: str, cache_dir: str) -> Graph:
    """:func:`parse_alist`, cached in ``cache_dir`` under the file's
    content hash (a changed file is parsed again)."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 24), b""):
            h.update(block)
    cached = os.path.join(cache_dir, f"graph-{h.hexdigest()[:20]}.npz")
    if os.path.exists(cached):
        z = np.load(cached)
        return Graph(int(z["n_vars"]), int(z["n_checks"]),
                     int(z["n_punctured"]), z["check_degrees"],
                     z["var_degrees"], z["adjacency"])
    g = parse_alist(path)
    os.makedirs(cache_dir, exist_ok=True)
    tmp = f"{cached}.{os.getpid()}.npz"
    np.savez(tmp, n_vars=g.n_vars, n_checks=g.n_checks,
             n_punctured=g.n_punctured, check_degrees=g.check_degrees,
             var_degrees=g.var_degrees, adjacency=g.adjacency)
    os.replace(tmp, cached)
    return g


@dataclass
class Buckets:
    """The graph on a device. ``checks``: per check degree d, (the checks
    [n], their edges [n, d]); ``vars``: per variable degree, (the
    variables [m], their edges [m, d]); ``edge_var``: [E] the variable of
    each edge. Edges are numbered check-major, as in the file."""

    checks: list
    vars: list
    edge_var: torch.Tensor

    @staticmethod
    def of(g: Graph, device) -> "Buckets":
        offsets = np.concatenate([[0], np.cumsum(g.check_degrees)])

        def groups(degrees, edges_of):
            out = []
            for d in np.unique(degrees):
                nodes = np.nonzero(degrees == d)[0]
                out.append((torch.from_numpy(nodes).to(device),
                            torch.from_numpy(edges_of(nodes, d)).to(device)))
            return out

        by_var = np.argsort(g.adjacency, kind="stable")
        var_offsets = np.concatenate([[0], np.cumsum(g.var_degrees)])
        return Buckets(
            checks=groups(g.check_degrees, lambda c, d: offsets[c][:, None]
                          + np.arange(d)[None, :]),
            vars=groups(g.var_degrees, lambda v, d: by_var[
                var_offsets[v][:, None] + np.arange(d)[None, :]]),
            edge_var=torch.from_numpy(g.adjacency).to(device))

    def syndromes(self, bits: torch.Tensor) -> torch.Tensor:
        """[n_checks, F] int8: each check's parity of ``bits`` [n_vars, F]
        (0/1 int8)."""
        n_checks = sum(c.numel() for c, _ in self.checks)
        out = torch.empty((n_checks, bits.shape[1]), dtype=torch.int8,
                          device=bits.device)
        for nodes, edges in self.checks:
            got = bits.index_select(0, self.edge_var[edges.reshape(-1)])
            out[nodes] = (got.view(*edges.shape, -1).sum(1, dtype=torch.int32)
                          & 1).to(torch.int8)
        return out
