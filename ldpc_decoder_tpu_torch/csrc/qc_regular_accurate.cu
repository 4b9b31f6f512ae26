// The PhiAccurate instantiations of the regular check and variable kernels
// (qc_regular.cuh): common.cuh's phi_abs with the family's clamp, the
// plain passes' phi, which the tests and chip_smoke.py reach through
// ops/qc_regular.py's internal _phi="accurate". Compiled beside
// qc_regular.cu, in parallel, into the same library. Never built with
// --use_fast_math.

#include "qc_regular.cuh"

namespace ldpc {
namespace regular {

#define LDPC_EXTERN
LDPC_FOR_EACH_DEGREE(LDPC_ACCURATE_DEGREE)
#undef LDPC_EXTERN

}  // namespace regular
}  // namespace ldpc
