"""The repository's sample codes at full size, cached as alists.

The port's counterpart of ``bench.py``'s ``get_code`` and
``get_reg36_code``: the same cache files under ``codes_cache/`` at the
root of the checkout, with the same ``#params`` construction headers, so a
cache written by either side is read by the other, and a stale one (a
header that differs) is rebuilt. ``chip_smoke.py``,
``scripts/fer_stats_torch.py`` and ``profile_chip.py`` share them.
:func:`get_bsc_code` builds the BSC rate-0.9 sample code as
``scripts/make_sample_codes.py`` does, under that script's file name; the
script writes it without a header, so the port adds one (``BSC_PARAMS``)
and rebuilds a cache that lacks it.
"""

from __future__ import annotations

import os

from ldpc_decoder_tpu_torch.codes.protographs import (
    p41_code,
    p41_shipped_params,
    regular_base,
)
from ldpc_decoder_tpu_torch.codes.qc import (
    load_qc_alist,
    make_qc_code,
    make_qc_structure_repair,
    qc_to_code,
    read_alist_params,
    write_qc_alist,
)

CACHE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "codes_cache")
P41_ALIST = os.path.join(CACHE, "code_awgn_rate_0.5_thr_0.95.alist")
REG36_ALIST = os.path.join(CACHE, "bench_qc36x_awgn_r05_1048576_g8.alist")
# bench.py's #params header of the regular (3,6) code
REG36_PARAMS = {"base": "reg36_16x32_s2", "Z": "32768", "seed": "1",
                "coarse": "1024", "fine_mod": "64", "min_girth": "8"}
BSC_ALIST = os.path.join(CACHE, "code_bsc_rate_0.9_thr_0.007.alist")
# the rate-0.9 code's construction (scripts/make_sample_codes.py:89-94):
# regular_base(8, 80, 3, 30, seed=3), lifted by the girth repair
BSC_PARAMS = {"base": "reg330_8x80_s3", "Z": "12288", "seed": "1",
              "coarse": "1024", "fine_mod": "64", "lift": "repair"}


def cached_code(path, want, build):
    """(code, structure, how) from the alist cache at ``path`` when its
    #params header equals ``want``, else built by ``build()`` and cached;
    ``how`` is "cache" or "built"."""
    if os.path.exists(path) and read_alist_params(path) == want:
        code, s = load_qc_alist(path)
        if s is not None:
            return code, s, "cache"
    code, s = build()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    write_qc_alist(code, s, path, params=want)
    return code, s, "built"


def get_code():
    """p41, the bench's flagship: the same file and header as bench.py."""
    return cached_code(P41_ALIST, p41_shipped_params(), p41_code)


def get_reg36_code():
    """The README's regular (3,6) 2^20 code: the same file, header and
    construction as bench.py's get_reg36_code."""

    def build():
        return make_qc_code(regular_base(16, 32, 3, 6, seed=2), Z=32768,
                            seed=1, coarse=1024, fine_mod=64, min_girth=8)

    return cached_code(REG36_ALIST, REG36_PARAMS, build)


def get_bsc_code():
    """The BSC rate-0.9 sample code (n = 983,040, d_v = 3, d_c = 30, girth
    8): scripts/make_sample_codes.py's construction and file name."""

    def build():
        base = regular_base(8, 80, 3, 30, seed=3)
        s = make_qc_structure_repair(base, Z=12288, seed=1, coarse=1024,
                                     fine_mod=64)
        return qc_to_code(s), s

    return cached_code(BSC_ALIST, BSC_PARAMS, build)
