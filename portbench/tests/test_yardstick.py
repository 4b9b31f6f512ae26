"""The frozen byte arithmetic against the port's own ``runtime/perf.py``
on the small codes of both QC families, and the launches a check pass
takes against the port's tables."""

import numpy as np
import pytest
import torch

from pbcore import yardstick
from pbcore.graph import parse_alist


@pytest.mark.parametrize("family", ["grouped", "regular"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float8_e5m2", "float32"])
@pytest.mark.parametrize("B", [16, 256])
def test_bytes_equal_the_ports(small_codes, family, dtype, B):
    from ldpc_decoder_tpu_torch.ops.qc_decode import QCDecodeTables
    from ldpc_decoder_tpu_torch.ops.qc_grouped import GroupedQCTables
    from ldpc_decoder_tpu_torch.ops.qc_regular import QCRegularTables
    from ldpc_decoder_tpu_torch.runtime import perf

    code, s, path = small_codes[family]
    g = parse_alist(path)
    assert yardstick.family(g) == family
    t = QCDecodeTables.from_structure(s, code.n_erased_vars, "cpu")
    msg = torch.empty((), dtype=getattr(torch, dtype)).element_size()
    llr = 4 if dtype == "float32" else 2
    if family == "grouped":
        tables = GroupedQCTables.from_qc_tables(t)
        want = perf.grouped_bytes(tables, B, msg, llr)
        assert yardstick.check_launches_per_pass(g) == len(tables.row_groups)
    else:
        tables = QCRegularTables.from_qc_tables(t)
        want = perf.regular_bytes(tables, B, msg, llr)
        assert yardstick.check_launches_per_pass(g) == 1
    got = yardstick.pass_bytes(g, s.Z, B, dtype)
    assert got == {k: want[k] for k in ("cn", "vn")}


def test_least_time_is_bytes_at_the_data_sheet_rate():
    assert yardstick.least_seconds(3.35e12) == 1.0
    assert yardstick.HBM_BYTES_PER_S == 3.35e12
