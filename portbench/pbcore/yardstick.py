"""The yardstick of the kernels' roofline shares: the card's published
memory rate and the bytes one decode pass must move.

A frozen copy of the port's ``runtime/perf.py`` byte arithmetic
(``grouped_bytes``, ``regular_bytes``), restated in terms of the code's
degrees, which the benchmark reads from the alist itself, so that no later
change to the program moves the yardstick. Per pass of a non-emit
iteration, for B frames, each input read once and each output written
once:

- check pass: every message read and every check-to-variable message
  written (2 E B message bytes), the int8 syndromes (n_checks B), and the
  slot tables (grouped: an int32 source block and shift per circulant
  block, 8 E / Z; regular: three int32 per slot, 12 E / Z);
- variable pass: the same for the variables it runs and their LLRs. The
  grouped family skips degree-1 variables (their message is their LLR's
  and is not rewritten), so it counts the edges and LLRs of the others.

The grouped family runs one check launch per check degree and one
variable launch per variable degree above 1 (the degree-1 group only on
iterations that emit hard bits or follow a refill); the regular family
one of each. Passes in a trace are therefore check launches over the check
degrees. Data sheet: NVIDIA H100 SXM, 3.35 TB/s of HBM3 at 700 W.
"""

from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12
DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "float8_e5m2": 1, "int8": 1}
# the LLR state's dtype: the message dtype's, bfloat16 for 1-byte messages
LLR_BYTES = {"float32": 4, "bfloat16": 2, "float8_e5m2": 2, "int8": 2}


def family(graph) -> str:
    """"regular" for one check degree and one variable degree (the port's
    regular QC kernels), else "grouped"."""
    one = (np.unique(graph.check_degrees).size == 1
           and np.unique(graph.var_degrees).size == 1)
    return "regular" if one else "grouped"


def check_launches_per_pass(graph) -> int:
    return 1 if family(graph) == "regular" else int(
        np.unique(graph.check_degrees).size)


def pass_bytes(graph, Z: int, B: int, message_dtype: str) -> dict:
    """{"cn", "vn"}: unique bytes of one check and one variable pass."""
    msg, llr = DTYPE_BYTES[message_dtype], LLR_BYTES[message_dtype]
    E = graph.n_edges
    if family(graph) == "regular":
        tables = 12 * (E // Z)
        return {"cn": 2 * E * B * msg + graph.n_checks * B + tables,
                "vn": 2 * E * B * msg + graph.n_vars * B * llr + tables}
    deg = graph.var_degrees
    vn_edges = int(deg[deg > 1].sum())
    vn_vars = int((deg > 1).sum())
    return {"cn": 2 * E * B * msg + graph.n_checks * B + 8 * (E // Z),
            "vn": 2 * vn_edges * B * msg + vn_vars * B * llr
            + 8 * (vn_edges // Z)}


def least_seconds(n_bytes: float) -> float:
    return n_bytes / HBM_BYTES_PER_S
