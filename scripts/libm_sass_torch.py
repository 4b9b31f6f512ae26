"""The SASS of the CUDA math library's accurate logf, cosf and sqrtf and of
the unsigned-to-float conversion, as the pool kernels of
``ldpc_decoder_tpu_torch/csrc/datagen.cu`` compile them (no fast math).

    python3 scripts/libm_sass_torch.py [OUT_DIR]

Builds one small library with the pool kernels' nvcc flags
(``_kernels.NVCC_FLAGS``), one kernel per function, each reading one value
per thread, applying the function once and storing the result; writes
each kernel's SASS to
``OUT_DIR/libm_sass.txt`` (default ``chiprun_out/``) and prints, per
function, the instructions between the kernel's load and its store (the
function's fast path and, for cosf and sqrtf, the slow paths it branches
over or calls). The constants of ``runtime/perf.py`` (``LOGF_SASS``,
``COSF_SASS``, ``SQRTF_SASS``, ``U2F_SASS``) were read from that listing
by hand, following the branches a finite argument of the pool kernels
takes. Needs ``nvcc`` and ``cuobjdump`` (the card's host), not a card.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

SOURCE = r"""
#include <cstdint>
extern "C" __global__ void k_logf(float* x) {
  const int i = threadIdx.x; x[i] = logf(x[i]);
}
extern "C" __global__ void k_cosf(float* x) {
  const int i = threadIdx.x; x[i] = cosf(x[i]);
}
extern "C" __global__ void k_sqrtf(float* x) {
  const int i = threadIdx.x; x[i] = sqrtf(x[i]);
}
extern "C" __global__ void k_u2f(float* x) {
  const int i = threadIdx.x;
  x[i] = __uint2float_rn(reinterpret_cast<uint32_t*>(x)[i]);
}
"""
FUNCTIONS = ("k_logf", "k_cosf", "k_sqrtf", "k_u2f")


def main(argv: list[str]) -> int:
    from ldpc_decoder_tpu_torch.ops import _kernels

    out_dir = argv[0] if argv else os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _kernels._nvcc()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    with tempfile.TemporaryDirectory() as tmp:
        src, lib = os.path.join(tmp, "libm.cu"), os.path.join(tmp, "libm.so")
        with open(src, "w") as f:
            f.write(SOURCE)
        subprocess.run([nvcc, *_kernels.NVCC_FLAGS, "-o", lib, src],
                       check=True, capture_output=True, timeout=300)
        sass = subprocess.run([cuobjdump, "-sass", lib], check=True,
                              capture_output=True, text=True,
                              timeout=300).stdout
    with open(os.path.join(out_dir, "libm_sass.txt"), "w") as f:
        f.write(sass)
    counts = {}
    for fn in sass.split("Function : ")[1:]:
        name = fn.split(None, 1)[0]
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                         r"([A-Z][A-Z0-9_.]*)", fn)
        load = next(i for i, op in enumerate(ops) if op.startswith("LDG"))
        store = max(i for i, op in enumerate(ops) if op.startswith("STG"))
        counts[name] = (store - load - 1, len(ops))
    for name in FUNCTIONS:
        between, total = counts[name]
        print(f"{name}: {between} instructions between the load and the "
              f"store, {total} in all")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
