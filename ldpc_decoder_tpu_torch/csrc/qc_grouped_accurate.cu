// The PhiAccurate instantiations of the grouped check and variable kernels
// (qc_grouped.cuh): common.cuh's phi_abs, the plain passes' phi, which the
// tests and chip_smoke.py reach through ops/qc_grouped.py's internal
// _phi="accurate". Compiled beside qc_grouped.cu, in parallel, into the
// same library. Never built with --use_fast_math.

#include "qc_grouped.cuh"

namespace ldpc {
namespace grouped {

#define LDPC_EXTERN
LDPC_FOR_EACH_DEGREE(LDPC_ACCURATE_DEGREE)
#undef LDPC_EXTERN

}  // namespace grouped
}  // namespace ldpc
