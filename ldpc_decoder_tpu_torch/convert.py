"""Carry state across from the JAX package to the port, as numpy arrays.

The system has no weights; what must carry across are the code tables and
the decoder state, so that one input can be fed to a JAX pass and to the
port's pass and the outputs compared:

- :func:`structure_from_numpy` builds the port's ``QCStructure`` from the
  numpy fields of a JAX ``QCStructure``;
- :func:`grouped_state_from_jax` maps the JAX grouped kernels' padded flat
  message layout (each degree group's first block rounded up to a multiple
  of its degree) into the port's unpadded ``[nb, Z, B]`` layout, and
  :func:`grouped_state_to_jax` maps back (padding blocks zero);
- :func:`regular_state_from_jax` maps the JAX regular family's 2-D
  ``[n_edges, B]`` messages (its runners' interface) into the port's
  ``[C, d_v, Z, B]`` and ``[R, d_c, Z, B]``, and
  :func:`regular_state_to_jax` maps back. Both sides keep the same edge
  order, so this is a reshape;
- :func:`general_state_from_jax` maps the JAX general path's padded
  plane-major arrays (``[ev_pad|ec_pad, B]`` edges, ``[nv_pad|nc_pad, B]``
  nodes) into the port's unpadded ones, and :func:`general_state_to_jax`
  maps back (pad rows zero).

The maps only move blocks or rows, so they carry any message dtype (float32,
bfloat16 widened to float32, int8) and any algorithm's state unchanged.
The JAX tables are only read through their group or bucket metadata
(``row_groups``/``col_groups`` with ``block_start``; ``vn_buckets``/
``cn_buckets`` with ``count_pad``, ``node_start``, ``edge_start``) and the
regular layout comes from the port's tables, so this module imports
neither JAX nor the JAX package.
"""

from __future__ import annotations

import numpy as np

from ldpc_decoder_tpu_torch.codes.qc import QCStructure


def structure_from_numpy(Z, n_base_rows, n_base_cols, edge_row, edge_col,
                         edge_shift) -> QCStructure:
    return QCStructure(
        Z=int(Z), n_base_rows=int(n_base_rows), n_base_cols=int(n_base_cols),
        edge_row=np.asarray(edge_row, np.int32),
        edge_col=np.asarray(edge_col, np.int32),
        edge_shift=np.asarray(edge_shift, np.int32),
    )


def block_map(jax_groups, port_groups) -> np.ndarray:
    """[nb] padded JAX block index of each port block (groups zipped in
    order; both sides list the same degrees and counts)."""
    out = []
    for jg, pg in zip(jax_groups, port_groups, strict=True):
        if (jg.degree, jg.count) != (pg.degree, pg.count):
            raise ValueError(f"group mismatch: JAX {jg} vs port {pg}")
        out.append(jg.block_start + np.arange(pg.count * pg.degree))
    return np.concatenate(out)


def _blocks(x, n_blocks, Z):
    x = np.asarray(x)
    return x.reshape(n_blocks, Z, x.shape[-1])


def grouped_state_from_jax(msgs_v, r_c, jax_tables, port_tables):
    """(msgs_v, r_c) in the JAX padded layout ([nbv_pad(*Z), (Z,) B] and
    [nbc_pad(*Z), (Z,) B]) -> the port's ([nb, Z, B], [nb, Z, B])."""
    Z = port_tables.Z
    mv = _blocks(msgs_v, jax_tables.nbv_pad, Z)
    rc = _blocks(r_c, jax_tables.nbc_pad, Z)
    pv = block_map(jax_tables.col_groups, port_tables.col_groups)
    pc = block_map(jax_tables.row_groups, port_tables.row_groups)
    return mv[pv], rc[pc]


def grouped_state_to_jax(msgs_v, r_c, jax_tables, port_tables):
    """The port's ([nb, Z, B], [nb, Z, B]) -> the JAX padded layout
    ([nbv_pad, Z, B], [nbc_pad, Z, B]); padding blocks are zero."""
    msgs_v, r_c = np.asarray(msgs_v), np.asarray(r_c)
    Z, B = port_tables.Z, msgs_v.shape[-1]
    mv = np.zeros((jax_tables.nbv_pad, Z, B), msgs_v.dtype)
    rc = np.zeros((jax_tables.nbc_pad, Z, B), r_c.dtype)
    mv[block_map(jax_tables.col_groups, port_tables.col_groups)] = msgs_v
    rc[block_map(jax_tables.row_groups, port_tables.row_groups)] = r_c
    return mv, rc


def regular_state_from_jax(msgs2d, r_c2d, port_tables):
    """(msgs_v, r_c) as JAX 2-D [n_edges, B] arrays (variable order, check
    order) -> the port's ([C, d_v, Z, B], [R, d_c, Z, B])."""
    t = port_tables
    msgs2d, r_c2d = np.asarray(msgs2d), np.asarray(r_c2d)
    B = msgs2d.shape[-1]
    return (msgs2d.reshape(t.C, t.d_v, t.Z, B),
            r_c2d.reshape(t.R, t.d_c, t.Z, B))


def regular_state_to_jax(msgs_v, r_c):
    """The port's ([C, d_v, Z, B], [R, d_c, Z, B]) -> JAX 2-D
    ([n_edges, B], [n_edges, B])."""
    msgs_v, r_c = np.asarray(msgs_v), np.asarray(r_c)
    B = msgs_v.shape[-1]
    return msgs_v.reshape(-1, B), r_c.reshape(-1, B)


def general_rows(jax_buckets, port_buckets, edges: bool = True) -> np.ndarray:
    """Padded JAX row of each port row, for the edge rows (``edges``) or the
    node rows of one side. ``jax_buckets`` are the JAX general tables'
    ``vn_buckets``/``cn_buckets`` (degree, count, count_pad, node_start,
    edge_start); ``port_buckets`` the port's (degree, count, row_start,
    edge_start), zipped in order. Slot k of node i sits at JAX row
    edge_start + k·count_pad + i and port row edge_start + k·count + i."""
    out = []
    for jb, pb in zip(jax_buckets, port_buckets, strict=True):
        if (jb.degree, jb.count) != (pb.degree, pb.count):
            raise ValueError(f"bucket mismatch: JAX {jb} vs port {pb}")
        i = np.arange(pb.count, dtype=np.int64)
        if edges:
            k = np.arange(pb.degree, dtype=np.int64)[:, None]
            out.append((jb.edge_start + k * jb.count_pad + i).reshape(-1))
        else:
            out.append(jb.node_start + i)
    return np.concatenate(out)


def general_state_from_jax(x, jax_buckets, port_buckets, edges: bool = True):
    """A JAX padded [ev_pad|ec_pad, B] edge array (``edges``) or [nv_pad|
    nc_pad, B] node array -> the port's unpadded [E, B] / [n, B]."""
    return np.asarray(x)[general_rows(jax_buckets, port_buckets, edges)]


def general_state_to_jax(x, jax_buckets, port_buckets, n_rows: int,
                         edges: bool = True):
    """The port's [E, B] / [n, B] -> the JAX padded layout with ``n_rows``
    rows (ev_pad, ec_pad, nv_pad or nc_pad); pad rows are zero."""
    x = np.asarray(x)
    out = np.zeros((n_rows,) + x.shape[1:], x.dtype)
    out[general_rows(jax_buckets, port_buckets, edges)] = x
    return out
